"""Proteins answered in the window over its seconds: each protein's record
counts when its last line reaches the client (answers stream back in
batches), so a genome-sized request adds to the rate as it is answered."""


def read(run):
    n = sum(k for r in run.records for t, k in zip(r.chunk_t, r.chunk_n)
            if run.t0 <= t < run.t_end)
    return n / run.seconds
