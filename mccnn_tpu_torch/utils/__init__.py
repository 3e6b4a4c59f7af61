from mccnn_tpu_torch.utils.config import MatchConfig, NetConfig, TrainConfig  # noqa: F401
