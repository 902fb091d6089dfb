"""Files a second of one decode-only pass over the cell's folder after the window
(``EncoderSession.decoded_batches``: the native decoder into the host ring), host clock."""


def read(r):
    n, s = r.spans.get("decode_pass", (0, 0.0))
    return n / s if n and s > 0 else None
