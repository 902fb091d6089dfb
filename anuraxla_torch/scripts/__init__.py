"""The port's pipeline driver and measurement drives — the port of the
reference's ``scripts/``. The shell scripts (``run_full_pipeline.sh``,
``01_normalize_chunks.sh`` … ``05_make_plots.sh``, the ``drive_*.sh``) run
``python -m anuraxla_torch <command>`` from a project directory; the two
diagnostics the reference's drives ran as inline Python are modules here:
``decision_diff`` (``drive_fast_tier.sh``) and ``noise_distance``
(``drive_5db_floor.sh``)."""
