"""Batches a second of the training mel stream alone (decode, the pageable
transfer, the mel kernel), timed over a run of batches after the window, host clock."""


def read(r):
    n, s = r.spans.get("mel_stream", (0, 0.0))
    return n / s if n and s > 0 else None
