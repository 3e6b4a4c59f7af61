from mccnn_tpu_torch.pipeline.match import MatchPipeline, match_pair  # noqa: F401
from mccnn_tpu_torch.pipeline.train import (  # noqa: F401
    hinge_loss,
    make_optimizer,
    make_train_step,
)
