"""setup_s: from the process's start to the window's opening: imports,
the weights made from the seed, the kernels built or loaded, the warm-up."""


def read(rec):
    return rec["setup_s"]
