"""setup_s: seconds from the start of the run's script to the window's first
call: imports, the kernels' build or load, weights and images made on the
card, warm-up."""


def read(records):
    return records["setup_s"]
