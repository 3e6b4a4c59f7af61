"""mccnn_tpu_torch — the stereo matching pipeline on PyTorch and CUDA.

A port of ``mccnn_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA H100 (``csrc/``, built at first
use by ``kernels/build.py``). Module names follow ``mccnn_tpu`` so each
module's counterpart is easy to find, and each package exports the names
its ``mccnn_tpu`` counterpart exports (``from mccnn_tpu_torch.pipeline
import match_pair``). The package imports neither JAX nor ``mccnn_tpu``:
it keeps its own copies of the numpy-only modules (io, utils,
data.dataset).
"""

import time as _time

_start = _time.perf_counter()

__version__ = "0.1.0"

from mccnn_tpu_torch.utils.config import MatchConfig, NetConfig, TrainConfig  # noqa: F401,E402
from mccnn_tpu_torch.utils import tracing as _tracing  # noqa: E402

_tracing.add("setup.import", _start, _time.perf_counter())
del _start, _time, _tracing
