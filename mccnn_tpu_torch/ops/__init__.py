"""The matching pipeline's operations (mccnn_tpu/ops/).

As in ``mccnn_tpu.ops``, ``cbca``, ``cbca_mxu``, ``cbca_pallas`` and
``sgm`` here are the functions, not the modules of those names: reach a
module with ``importlib.import_module("mccnn_tpu_torch.ops.cbca")``.
"""

from mccnn_tpu_torch.ops.cost_volume import cost_volume_pair, pad_disparities  # noqa: F401
from mccnn_tpu_torch.ops.cbca import compute_arms, cbca  # noqa: F401
from mccnn_tpu_torch.ops.cbca_mxu import cbca_mxu  # noqa: F401
from mccnn_tpu_torch.ops.cbca_pallas import cbca_pallas  # noqa: F401
from mccnn_tpu_torch.ops.cost_volume import band_pair_pallas  # noqa: F401
from mccnn_tpu_torch.ops.sgm import sgm  # noqa: F401
from mccnn_tpu_torch.ops.wta import wta_disparity  # noqa: F401
from mccnn_tpu_torch.ops.lr_check import lr_consistency_interpolate  # noqa: F401
from mccnn_tpu_torch.ops.subpixel import subpixel_enhance  # noqa: F401
from mccnn_tpu_torch.ops.filters import bilateral_filter, median_filter  # noqa: F401
