"""``benchmark-folder-map`` on the port — labelled-folder benchmark with the
MAP detector (the reference's ``10b_benchmark_folder_detection_map.py``, as
``anuraxla/cli/benchmark_folder_map.py``; artifacts under
outputs/detection_benchmark_map/, the same flags as ``benchmark-folder``).

    python -m anuraxla_torch benchmark-folder-map --root val_chunks
"""

from anuraxla_torch.cli.benchmark_folder import run


def main(argv=None) -> None:
    # the reference MAP benchmark defaults to val_chunks (10b:300)
    run("map", "outputs/detection_benchmark_map", default_root_name="val_chunks", argv=argv)


if __name__ == "__main__":
    main()
