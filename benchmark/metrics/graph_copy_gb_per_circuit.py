"""GB per circuit that the program's graph cache copied into its graphs'
static inputs and cloned out of their outputs (`spans.COUNTS`:
`copy_in_bytes` + `clone_out_bytes`), traced run."""


def read(run):
    c = run.counters
    if not c or not run.ends:
        return None
    total = c["copy_in_bytes"] + c["clone_out_bytes"]
    return total / len(run.ends) * 1e-9 if total else None
