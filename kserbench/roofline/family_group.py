"""The bytes a row-local family rollup needs: the [B, W, D] family rows
(int32) and the D 1/degree weights read; per row its group count, and
per group its family, count, weight and first slot written (4 B each)."""

GROUP_BYTES = 4 * 4

KERNELS = ("family_group_kernel", "family_group_sorted_kernel")


def bytes_moved(B: int, W: int, D: int, groups: int) -> int:
    return B * W * D * 4 + D * 4 + B * 4 + groups * GROUP_BYTES
