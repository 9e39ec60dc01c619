"""The work function of the `swin_window` operation: the least time of a
frame's Swin window reads, the reads that reference/encoders/swin_base.py
declares (`SWIN_WINDOW`, role 'enc_window'), each counted by its own work
function there: 4 * 49 * d FLOPs a head and in-image query, and the
in-image tokens' q, k, v and out once each plus the bias table (fp32)."""

from vosbench import work


def swin_window(reads) -> float:
    return work.op_bound_s(reads, "enc_window")
