"""Time the span route's host copy strategies on the card's machine: a batch's
int16 runs (~246 MB, 12 recordings x 600 s at 48 kHz) from fresh memmaps into
a pinned int16 buffer, single-threaded, split over 2/4/8 threads, and by
os.preadv."""
import os, sys, time, tempfile, json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
import numpy as np, torch
sys.path.insert(0, os.getcwd())
from anuraxla_torch.utils.wavio import write_wav, WavStream

d = Path(tempfile.mkdtemp())
rng = np.random.default_rng(1)
paths = []
for i in range(12):
    p = d / f"r{i}.wav"
    write_wav(p, (0.05 * rng.standard_normal(48000 * 600)).astype(np.float32), 48000)
    paths.append(p)
os.sync()
print("fs:", os.popen(f"df -T {d} | tail -1").read().strip())
N = 1024 * 120000 + 120000  # one batch's source samples
buf = torch.zeros(N + 4096, dtype=torch.int16, pin_memory=True).numpy()

def plan(batch):  # (file, a, b, dst) runs of batch `batch` of the 12 x 28.8 M-sample fleet
    n_file = 48000 * 600
    start = batch * 1024 * 120000
    out, pos, left = [], 0, N
    f, a = divmod(start, n_file)
    while left > 0 and f < 12:
        b = min(n_file, a + left)
        out.append((f, a, b, pos)); pos += b - a; left -= b - a; f += 1; a = 0
    return out

def copy_runs(streams, runs, threads):
    pieces = []
    for f, a, b, p in runs:
        step = -(-(b - a) // threads)
        for o in range(a, b, step):
            e = min(b, o + step)
            pieces.append((f, o, e, p + o - a))
    def one(x):
        f, o, e, q = x
        buf[q:q + e - o] = streams[f].read_i16(o, e - o)
    if threads == 1:
        for x in pieces: one(x)
    else:
        with ThreadPoolExecutor(threads) as ex: list(ex.map(one, pieces))

def pread_runs(runs):
    for f, a, b, p in runs:
        with open(paths[f], "rb") as fh:
            off = WavStream(paths[f])._mm.offset
            mv = memoryview(buf[p:p + b - a]).cast("B")
            got = os.preadv(fh.fileno(), [mv], off + 2 * a)
            assert got == 2 * (b - a)

res = {}
for rep in range(4):
    for name in ["memmap1", "memmap2", "memmap4", "memmap8", "preadv"]:
        batch = rep % 3
        runs = plan(batch)
        t = time.perf_counter()
        if name == "preadv":
            pread_runs(runs)
        else:
            streams = [WavStream(p) for p in paths]  # fresh maps, as each scan pass opens them
            copy_runs(streams, runs, int(name[6:]))
        res.setdefault(name, []).append(round((time.perf_counter() - t) * 1e3, 2))
print(json.dumps(res))
print("cpus", os.cpu_count(), "GB/s at median:", {k: round(2 * N / 1e6 / sorted(v)[len(v)//2], 2) for k, v in res.items()})
