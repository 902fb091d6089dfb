"""Host time of the folder benchmark's tree scan (the program's ``tree_scan``
spans inside the traced window: ``scan_species_tree`` in
``run_folder_benchmark``), a pass."""


def read(r):
    if r.trace is None or not r.window.calls:
        return None
    try:
        from anuraxla_torch.utils.timing import spans
    except ImportError:  # a program without spans
        return None
    ms = [(x.end_ns - x.start_ns) * 1e-6 for x in spans(*r.trace.window) or () if x.name == "tree_scan"]
    return sum(ms) / r.window.calls if ms else None
