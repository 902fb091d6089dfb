"""The kernel study's harness — the port of the reference's probe scripts
(``scripts/bench_kernel_variants.py``, ``probe_phase_variants.py``,
``probe_kernel_ablation.py``, ``profile_stages.py``, ``_probe_common.py``).
Each module runs as ``python -m anuraxla_torch.probes.<name>`` on the card
(``--device cuda``, the default) and prints one JSON line per measurement."""
