"""dispatch_ms.open: mean host ms in MatchPipeline.dispatch a request over
the window of an open loop (harness span around the call)."""

from portbench.readers import dispatch_ms


def read(run):
    return dispatch_ms(run)
