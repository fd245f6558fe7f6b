"""``segment_sum_roofline_pct.pair``: K3 sum's share of its roofline, over the
traced calls of ``segment_rows_sum`` (its sort, row take and sum)
(``op_roofline.op_roofline``)."""

import op_roofline


def read(ctx):
    return op_roofline.op_roofline(ctx, "segment_rows_sum")
