"""Process start to the first timed circuit (host clock): imports, the
kernel library (built by nvcc on a checkout's first run only), contexts,
keys, the input pool and the captures of the cell's own signatures."""


def read(run):
    return run.setup_s
