"""mpix_per_s: the user's pixels (H x W before bucket padding) of every
pair answered in the window, over the window's seconds: from the first
dispatch to the last map on the host (the loop stops dispatching at the
window's nominal end and fetches what is in flight)."""

from portbench.readers import answered


def read(run):
    done = answered(run)
    if not done or run.window_s <= 0:
        return None
    return sum(r.pixels for r in done) / 1e6 / run.window_s
