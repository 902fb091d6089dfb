"""The port's command-line entry points, named as the reference's
(``anuraxla/cli/__init__.py``): ``python -m anuraxla_torch <name>`` or
``python -m anuraxla_torch.cli.<module>``. Each module's ``main(argv=None)``
runs on the card unless ``--device cpu``.

Reference script        -> command
00_normalize_dataset_rms   normalize
07_encode_wav_to_latent    encode-wav
08_fit_radial_detector     fit-radial
08b_fit_map_detector       fit-map
09_evaluate_wav_detection  evaluate-wav
09n_..._map                evaluate-wav-map
10_benchmark_folder        benchmark-folder
10b_..._map                benchmark-folder-map
9100_spearman_rk_analysis  spearman-analysis
9105_make_config_snapshot  snapshot-from-log
9200_run_qout_grid         run-qout-grid
(extra)                    scan-soundscape, calibrate-tau, bench

The JAX package's train-vae, print-latents, make-synth-data, ingest-encoder
and ingest-decoder are not ported yet.
"""

COMMANDS = {
    "normalize": "anuraxla_torch.cli.normalize",
    "encode-wav": "anuraxla_torch.cli.encode_wav",
    "fit-radial": "anuraxla_torch.cli.fit_radial",
    "fit-map": "anuraxla_torch.cli.fit_map",
    "evaluate-wav": "anuraxla_torch.cli.evaluate_wav",
    "evaluate-wav-map": "anuraxla_torch.cli.evaluate_wav_map",
    "benchmark-folder": "anuraxla_torch.cli.benchmark_folder",
    "benchmark-folder-map": "anuraxla_torch.cli.benchmark_folder_map",
    "spearman-analysis": "anuraxla_torch.cli.spearman_analysis",
    "snapshot-from-log": "anuraxla_torch.cli.snapshot_from_log",
    "run-qout-grid": "anuraxla_torch.cli.run_qout_grid",
    "scan-soundscape": "anuraxla_torch.cli.scan_soundscape",
    "calibrate-tau": "anuraxla_torch.cli.calibrate_tau",
    "bench": "anuraxla_torch.bench",
}

# numeric aliases matching the reference filenames
ALIASES = {
    "00": "normalize",
    "07": "encode-wav",
    "08": "fit-radial",
    "08b": "fit-map",
    "09": "evaluate-wav",
    "09n": "evaluate-wav-map",
    "10": "benchmark-folder",
    "10b": "benchmark-folder-map",
    "9100": "spearman-analysis",
    "9105": "snapshot-from-log",
    "9200": "run-qout-grid",
}
