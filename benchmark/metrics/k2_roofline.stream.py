"""k2_roofline.stream: K2's (csrc/cbca_round.cu) bound a launch over its
mean device time a launch in the traced stretch, in %.

K2 is the walk kernel at 256 threads a block, 16-row steps and 256-row
bands, in bf16 or f32 (K7, K4 and K8 instantiate the same template with
other parameters). Its bound: the launch's volume, or disparity chunk, read
once and written once, its four int32 arm planes and its f32 1 / region
plane read once, at HBM's rate.
"""

import re
import statistics

from portbench import arith
from portbench.trace import kernel_times

KERNEL = re.compile(r"cbca_walk_kernel<(__nv_bfloat16|float), (13|16), "
                    r"256, 16, (16|8), 256>")
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    if run.trace is None:
        return None
    times = kernel_times(run.trace, KERNEL.search)
    if not times:
        return None
    c = run.config
    bucket = c["pipeline"]["bucket"]
    d_pad = arith.d_pad(c["ndisp"])
    lanes = min(c["pipeline"].get("cbca_chunk_d") or d_pad, d_pad)
    nbytes = arith.cbca_round_bytes(
        arith.padded(c["height"], bucket), arith.padded(c["width"], bucket),
        lanes, ELEMENT_BYTES[c["pipeline"]["volume_dtype"]])
    return 100.0 * arith.bound_seconds(nbytes) / statistics.fmean(times)
