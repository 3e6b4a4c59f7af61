from mccnn_tpu_torch.data.dataset import StereoDataset, load_grayscale  # noqa: F401
from mccnn_tpu_torch.data.sampler import TripletSampler  # noqa: F401
