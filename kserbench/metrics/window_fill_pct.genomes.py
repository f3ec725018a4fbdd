"""Batch engine: the windows the proteins hold (len - 8 each, counted at
FastAnnotator.pad_batch) over the windows the device program encodes
(encode_windows' [B, L - 8], padding rows and columns included)."""


def read(run):
    rec = run.recorder
    if rec is None or not rec.probed_windows:
        return None
    return 100.0 * rec.valid_windows / rec.probed_windows
