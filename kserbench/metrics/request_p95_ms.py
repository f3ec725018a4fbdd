"""The 95th percentile of the time from sending a request to the last
byte of its answer, over every request sent in the window (those in
flight at its close are waited for); a request never answered is left to
the check, which fails the run."""

from kserbench.harness.layers import percentile


def read(run):
    lat = [r.t_done - r.t_send for r in run.records
           if r.t_send < run.t_end and r.ok and r.t_done is not None]
    p = percentile(lat, 95)
    return None if p is None else p * 1e3
