"""A cell is data: a new traffic mix and a new workload file, named in the
manifest, are found and run with no edit to any file of the harness."""

from __future__ import annotations

import json
import shutil

from perfbench import harness
from perfbench.tests import tiny


def test_new_cell_found_by_name(tmp_path):
    pb = tmp_path / "perfbench"
    for d in ("configs", "traffic", "workloads"):
        shutil.copytree(harness.PB / d, pb / d)
    mix = harness.load_json(pb / "traffic" / "folder-4x512.json")
    mix.update(per_species=2, calibration_per_species=2, distractor_share=0.5)
    (pb / "traffic" / "folder-4x2.json").write_text(json.dumps(mix))
    wl = harness.load_json(pb / "workloads" / "stride-folder-balanced.json")
    wl["session"].update(batch_size=3, encoder_dtype="float32")
    wl["warmup_calls"] = 1
    (pb / "workloads" / "avgpool-folder-tiny.json").write_text(json.dumps(wl))
    m = tiny.manifest()
    m["workloads"].append({"name": "avgpool-folder-tiny", "config": "vae-avgpool", "traffic": "folder-4x2",
                           "chips": 1, "why": "a cell added as data"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "stride-folder-balanced" in e.get("workloads", []):
            e["workloads"].append("avgpool-folder-tiny")
    cell = harness.load_cell("avgpool-folder-tiny", m, pb=pb)
    assert cell.kind == "folder" and cell.cfg["downsample"] == "avgpool"
    res, _ = tiny.run(cell, m=m)
    assert res["correct"] is True and set(res["metrics"]) == {"chunks_per_s", "setup_s"}
    res, _ = tiny.run(cell, m=m, trace=True)
    assert {"decode_files_per_s", "mfu_pct"} <= set(res["metrics"])
