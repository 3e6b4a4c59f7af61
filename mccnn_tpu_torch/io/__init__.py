from mccnn_tpu_torch.io.pfm import read_pfm, write_pfm  # noqa: F401
from mccnn_tpu_torch.io.calib import parse_calib  # noqa: F401
from mccnn_tpu_torch.io.middlebury import (  # noqa: F401
    ensure_dir,
    ensure_dirs,
    save_disparity_pgm,
    save_time_file,
)
