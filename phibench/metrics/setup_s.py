"""Process start to the window's first call: build or library load, weights,
Phi calibration, warm-up."""


def read(run):
    return run.setup_s
