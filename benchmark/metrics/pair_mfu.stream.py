"""pair_mfu.stream: the share, in %, of the card's peak that a pair's
operations take in the measured seconds a pair: the least time of the
pair's operations at each stage's peak (portbench.arith: the paper's
algorithm for the configuration's ``net`` on the user's pixels and real
disparities, no padding) times the pairs answered, over the window's
seconds."""

from portbench import arith
from portbench.readers import answered


def read(run):
    done = answered(run)
    if not done or run.window_s <= 0:
        return None
    c = run.config
    match = c["match"]
    rounds = match["cbca_num_iterations_1"] + match["cbca_num_iterations_2"]
    ideal = arith.ideal_pair_seconds(c["height"], c["width"], c["ndisp"],
                                     rounds, c["pipeline"]["volume_dtype"],
                                     c["net"])
    return 100.0 * ideal * len(done) / run.window_s
