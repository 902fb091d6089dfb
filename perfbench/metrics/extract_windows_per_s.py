"""Windows a second of one extraction-only pass over the fleet after the window
(``pipeline.stream.fleet_window_batches``), host clock."""


def read(r):
    n, s = r.spans.get("extract_pass", (0, 0.0))
    return n / s if n and s > 0 else None
