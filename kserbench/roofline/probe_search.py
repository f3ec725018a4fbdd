"""The bytes a probe of signature-kmer windows needs, whatever probes
them (the binary search on its search rows, payload-wide rows, sub
blocks): each window's code read and its outputs written, and for each
window that matches, the matching key and its payload read once."""

# a window's code: hi and lo (int32) and its valid flag (one byte)
CODE_BYTES = 4 + 4 + 1
# its outputs: found (one byte), fi, oi, avg_off, wt and the DB row
OUT_BYTES = 1 + 5 * 4
# a match: the key's lo code, and its payload fi, oi, avg_off, wt
MATCH_BYTES = 4 + 4 * 4

KERNELS = ("row_search_kernel",)


def bytes_moved(windows: int, found: int) -> int:
    return windows * (CODE_BYTES + OUT_BYTES) + found * MATCH_BYTES
