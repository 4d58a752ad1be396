"""Seconds from process start to the first timed request: imports, CUDA
initialisation, kernel libraries loaded (built, in a checkout's first
run), problem generation, set-up and warm-up."""


def read(rec):
    return rec["setup_s"]
