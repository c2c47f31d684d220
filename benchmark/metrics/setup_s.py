"""setup_s: host seconds from the start of the process's benchmark code to
the end of set-up (imports, the kernels' build or load, seeded weights and
inputs, the model, the warm-up and the check's set-up readings)."""


def read(r):
    return r.setup_s
