"""dispatch_ms.stream: mean host ms in MatchPipeline.dispatch a pair over
the window of a closed loop (harness span around the call)."""

from portbench.readers import dispatch_ms


def read(run):
    return dispatch_ms(run)
