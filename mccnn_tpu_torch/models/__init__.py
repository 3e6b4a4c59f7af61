from mccnn_tpu_torch.models.net import (  # noqa: F401
    extract_features,
    init_params,
    patch_descriptors,
)
from mccnn_tpu_torch.models.params import (  # noqa: F401
    load_params,
    load_reference_npy_dict,
    save_params,
    save_reference_npy_dict,
)
