"""Process start to the first timed call: imports, the CUDA context, kernel loads or builds, inputs, weights, warm-up."""


def read(r):
    return r.setup_s
