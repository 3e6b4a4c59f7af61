"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, the result line.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``benchmark/configs/<config>.json`` (the ``file`` that
  ``BENCHMARK.json`` gives the configuration): the net, the sizes, the
  ``MatchPipeline`` options, the scene pool, the reference's name and the
  limits of the comparison;
* ``benchmark/traffic/<traffic>.json``: the loop (closed or open), the
  scene families in turn and, for an open loop, the rate;
* ``benchmark/metrics/<metric>.py``: ``read(run)`` returns the metric's
  value, or None where the run holds nothing to read;
* ``benchmark/reference/<reference>.py``: ``match(...)``, the plain
  reference.

The program under test is ``mccnn_tpu_torch``'s ``MatchPipeline``, driven
through ``dispatch`` and ``fetch`` as its server drives it.

A configuration's ``net`` states the MC-CNN architecture by the paper's
hyperparameters (Zbontar & LeCun, arXiv:1510.05970, section 3):
``num_layers`` N convolutions of ``num_maps`` maps, ``kernel_size``
square and VALID, on ``input_channels`` channels, and optionally
``num_fc_layers`` L and ``num_fc_units`` U. Without them, or with L = 0,
the net is the fast one: ``conv1..convN``, the last without ReLU, the two
descriptors normalised and compared by a dot product. With L > 0 it is
the accurate one, whose layers are, in this order:

* ``conv1..convN``, ReLU after each, the last too, no normalisation;
* ``fc1``: 2 * ``num_maps`` -> U, its input ``[left ; right]``, the left
  patch's descriptor first;
* ``fc2..fcL``: U -> U, ReLU after each of ``fc1..fcL``;
* ``fc{L+1}``: U -> 1, a sigmoid s; the matching cost is -s.

``make_weights`` draws every one of these layers, and ``params_tree``
gives them in the program's format. The fast net's layers take the Glorot
limit; the accurate net's take the He limit, since it has no normalisation:
Glorot halves a ReLU tower's signal at every layer, and the sigmoid then
sits at 0.5 whatever the disparity.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "mccnn_tpu")
CHECK_GAP_PX = 1.0  # a pixel counts as differing above this many pixels
HOST_TRACE_PAIRS = 3  # pairs of the stretch that also records the host
UNCOMPARED_PX = 1e9  # mean_abs_px of a window with no map to compare


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, manifest: dict | None = None,
              overrides: dict | None = None) -> Cell:
    """The cell named ``workload`` in ``BENCHMARK.json``, with its files
    read: the configuration from the ``file`` its entry names (relative to
    the checkout), the traffic by name; ``overrides`` replace
    configuration keys (the CPU tests' sizes)."""
    manifest = manifest or read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    files = {c["name"]: c["file"] for c in manifest["configs"]}
    config = read_json(ROOT / files[entry["config"]])
    config.update(overrides or {})
    traffic = read_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=workload, chips=int(entry["chips"]), config=config,
        traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, workload)],
    )


def manifest_with_put_off() -> dict:
    """``BENCHMARK.json`` with the entries of ``benchmark/put_off.json``
    added: cells whose files are kept, but which the benchmark does not
    run until their end-to-end metric holds a bound (the sweep and the CPU
    tests still drive them)."""
    manifest = read_json(ROOT / "BENCHMARK.json")
    for key, entries in read_json(BENCH / "put_off.json").items():
        manifest[key] = manifest[key] + entries
    return manifest


def metric_reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_")).read


# ---- inputs made from the seed ----------------------------------------------

def make_weights(seed: int, net: dict, device):
    """Uniform weights and small uniform biases of every layer of ``net``
    (the module docstring's layout), drawn on the device in two calls: all
    weights, then all biases, in layer order. Returns (weights, biases),
    lists in layer order: convolutions OIHW, fully connected layers (out,
    in) as ``F.linear`` takes them.

    A net without fully connected layers takes the Glorot limit sqrt(6 /
    (fan_in + fan_out)), bit for bit what the fast net always drew: its
    descriptors are normalised, so their scale cancels. A net with them has
    no normalisation and takes the He limit sqrt(6 / fan_in) at every layer
    (arXiv:1502.01852): Glorot halves a ReLU tower's second moment at each
    layer, and the sigmoid then gives about the same cost at every
    disparity."""
    import torch

    k, maps, cin = net["kernel_size"], net["num_maps"], net["input_channels"]
    shapes = [(maps, cin if i == 0 else maps, k, k)
              for i in range(net["num_layers"])]
    fc_layers = net.get("num_fc_layers", 0)
    if fc_layers:
        units = net["num_fc_units"]
        shapes += ([(units, 2 * maps)] + [(units, units)] * (fc_layers - 1)
                   + [(1, units)])
    sizes = [math.prod(s) for s in shapes]
    widths = [s[0] for s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.default_rng([seed, 1]).integers(2**62)))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    bias = (torch.rand(sum(widths), generator=gen, device=device)
            * 2 - 1) * net["bias_range"]
    weights = []
    for shape, chunk in zip(shapes, torch.split(flat, sizes)):
        receptive = math.prod(shape[2:])
        fan_in, fan_out = receptive * shape[1], receptive * shape[0]
        limit = math.sqrt(6.0 / (fan_in if fc_layers else fan_in + fan_out))
        weights.append((chunk * limit).reshape(shape).contiguous())
    return weights, list(torch.split(bias, widths))


def params_tree(weights, biases) -> dict:
    """The program's weight format, numpy: {"conv{i}": {"w": HWIO, "b"}}
    for the convolutions and {"fc{j}": {"w": (in, out), "b": (out,)}} for
    the fully connected layers, input before output as HWIO has it."""
    tree, counts = {}, {"conv": 0, "fc": 0}
    for w, b in zip(weights, biases):
        kind = "conv" if w.dim() == 4 else "fc"
        counts[kind] += 1
        layout = w.permute(2, 3, 1, 0) if kind == "conv" else w.t()
        tree[f"{kind}{counts[kind]}"] = {"w": layout.cpu().numpy(),
                                         "b": b.cpu().numpy()}
    return tree


def make_pool(seed: int, config: dict, traffic: dict, device) -> list:
    """The cell's scene pool: ``scene_pool`` pairs, the traffic's families
    in turn."""
    from portbench.scenes import make_pair

    families = traffic["families"]
    pool = []
    for i in range(config["scene_pool"]):
        family = families[i % len(families)]
        left, right = make_pair(family, seed, i, config["height"],
                                config["width"],
                                config["ndisp"] - config["disparity_margin"],
                                device)
        pool.append({"family": family, "left": left, "right": right})
    return pool


def due_times(seed: int, count: int, seconds: float) -> np.ndarray:
    """Arrival times of an open loop: ``count`` gaps at the quantiles of an
    exponential distribution, in an order drawn from ``seed``, scaled to
    fill ``seconds``. The cells draw the order from their traffic file's
    ``arrivals_seed``, not from the run's: a queue's tail follows the
    order of its gaps, and every run offers the same arrivals."""
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q)
    np.random.default_rng([seed, 2]).shuffle(gaps)
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def check_sample(seed: int, pool: list, count: int) -> list:
    """Pool indices whose outputs are compared: one of each family first,
    drawn from the seed, then others."""
    rng = np.random.default_rng([seed, 3])
    families = list(dict.fromkeys(p["family"] for p in pool))
    rng.shuffle(families)
    chosen = []
    for family in families:
        members = [i for i, p in enumerate(pool) if p["family"] == family]
        chosen.append(int(rng.choice(members)))
    rest = [i for i in range(len(pool)) if i not in chosen]
    rng.shuffle(rest)
    return (chosen + rest)[:count]


# ---- the loops ----------------------------------------------------------------

@dataclass
class Request:
    index: int
    pool: int
    due: float
    pixels: int
    t_dispatch: float = math.nan
    t_dispatched: float = math.nan
    t_done: float = math.nan
    after_wait: bool = False
    error: str | None = None
    output: object = None


@contextmanager
def span(name: str):
    import torch

    with torch.profiler.record_function("portbench." + name):
        yield


class Server:
    """The program as a user's loop drives it: ``dispatch`` enqueues a pair
    and returns, ``fetch`` waits for its map on the host."""

    def __init__(self, pipeline, pool: list, ndisp: int):
        self.pipeline = pipeline
        self.pool = pool
        self.ndisp = ndisp
        self.clock = time.perf_counter
        self.handles = {}

    def dispatch(self, req: Request) -> None:
        pair = self.pool[req.pool]
        with span("dispatch"):
            req.t_dispatch = self.clock()
            try:
                self.handles[req.index] = self.pipeline.dispatch(
                    pair["left"], pair["right"], self.ndisp)
            except Exception as exc:  # noqa: BLE001 -- a failed pair counts
                req.error = f"dispatch: {exc!r}"[:300]
            req.t_dispatched = self.clock()

    def fetch(self, req: Request) -> None:
        handle = self.handles.pop(req.index, None)
        with span("fetch"):
            if handle is not None:
                try:
                    req.output = self.pipeline.fetch(handle)
                except Exception as exc:  # noqa: BLE001
                    req.error = f"fetch: {exc!r}"[:300]
            req.t_done = self.clock()


def closed_loop(server: Server, pool_size: int, seconds: float,
                first: int = 0, count: int | None = None) -> list:
    """Dispatch pair N, then fetch pair N-1, until ``seconds`` have passed
    (or ``count`` pairs are dispatched); then fetch the last. Times are on
    ``server.clock``, from its start."""
    reqs, prev, i = [], None, first
    start = server.clock()
    while (count is None and server.clock() - start < seconds) or (
            count is not None and len(reqs) < count):
        req = Request(i, i % pool_size, server.clock(), 0)
        server.dispatch(req)
        reqs.append(req)
        if prev is not None:
            server.fetch(prev)
        prev, i = req, i + 1
    if prev is not None:
        server.fetch(prev)
    return reqs


def open_loop(server: Server, pool_size: int, dues: np.ndarray,
              first: int = 0, grace: float = 60.0) -> list:
    """Requests arrive at ``dues`` (seconds from the loop's start) and
    queue in order. The loop dispatches the next request that is due, then
    fetches the one before it; with nothing due it fetches the request in
    flight, or sleeps until the next arrival. Requests not dispatched
    ``grace`` seconds past the last arrival are left unanswered."""
    start = server.clock()
    reqs = [Request(first + k, (first + k) % pool_size, start + float(d), 0)
            for k, d in enumerate(dues)]
    nxt, inflight, waited = 0, None, False
    deadline = start + float(dues[-1]) + grace
    while nxt < len(reqs) or inflight is not None:
        now = server.clock()
        if nxt < len(reqs) and now > deadline:
            break
        if nxt < len(reqs) and reqs[nxt].due <= now:
            req = reqs[nxt]
            req.after_wait = waited
            waited = False
            server.dispatch(req)
            prev, inflight, nxt = inflight, req, nxt + 1
            if prev is not None:
                server.fetch(prev)
        elif inflight is not None:
            server.fetch(inflight)
            inflight = None
        else:
            with span("wait"):
                time.sleep(max(0.0, reqs[nxt].due - server.clock()))
            waited = True
    return reqs


# ---- a run --------------------------------------------------------------------

@dataclass
class Run:
    """What a run collected; the metric readers read it."""

    cell: Cell
    setup_s: float = math.nan
    setup: dict = field(default_factory=dict)
    requests: list = field(default_factory=list)
    window: tuple = (math.nan, math.nan)
    memory_peak_bytes: int = 0
    stretch: list = field(default_factory=list)
    trace: object = None
    host_trace: object = None
    launches: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def config(self) -> dict:
        return self.cell.config


def process_age() -> float:
    """Seconds since this process started, from /proc (0.01 s steps)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def _pipeline(params, config: dict, device: str, overrides: dict | None):
    from mccnn_tpu_torch.pipeline.match import MatchPipeline
    from mccnn_tpu_torch.utils.config import MatchConfig

    options = dict(config["pipeline"])
    options.update(overrides or {})
    return MatchPipeline(params, config=MatchConfig(**config["match"]),
                         device=device, **options)


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _warm(server: Server, pool_size: int, device: str) -> None:
    """The loop's pattern on two pairs: two in flight, then both fetched,
    so kernels, cuDNN's choice and the allocator's pools are set up."""
    reqs = [Request(-1 - k, k % pool_size, 0.0, 0) for k in range(2)]
    server.dispatch(reqs[0])
    server.dispatch(reqs[1])
    server.fetch(reqs[0])
    server.fetch(reqs[1])
    _sync(device)
    for req in reqs:
        if req.error:
            raise RuntimeError(f"warm-up pair failed: {req.error}")


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
          pipeline_overrides: dict | None = None, inject=None,
          pairs: int | None = None):
    """Set up, run the window (and with ``trace`` a traced stretch after
    it), and return (run, weights, pool) with the program freed.

    ``inject(pipeline)`` may wrap the program (the tests' planted
    faults). ``pairs`` replaces the window by a closed loop over that many
    pairs (the calibration's readings)."""
    import torch

    config, traffic = cell.config, cell.traffic
    clock = time.perf_counter
    run = Run(cell=cell)
    marks = {"start": clock()}
    launches = None
    if device.startswith("cuda"):
        from mccnn_tpu_torch.kernels import build

        _, compile_s = build.build()
        build.library()
        run.setup["compile_s"] = compile_s
        launches = build.LAUNCHES
    marks["library"] = clock()
    weights, biases = make_weights(seed, config["net"], device)
    pipeline = _pipeline(params_tree(weights, biases), config, device,
                         pipeline_overrides)
    if inject is not None:
        pipeline = inject(pipeline)
    marks["weights"] = clock()
    pool = make_pool(seed, config, traffic, device)
    pixels = config["height"] * config["width"]
    marks["scenes"] = clock()
    server = Server(pipeline, pool, config["ndisp"])
    _warm(server, len(pool), device)
    marks["warm"] = clock()
    names = ("library", "weights", "scenes", "warm")
    prev = "start"
    for name in names:
        run.setup[f"{name}_s"] = marks[name] - marks[prev]
        prev = name
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    if launches is not None:
        launches.reset()
    run.setup_s = process_age()

    t0 = clock()
    if pairs is not None:
        reqs = closed_loop(server, len(pool), 0.0, count=pairs)
    elif traffic["loop"] == "closed":
        reqs = closed_loop(server, len(pool), seconds)
    else:
        count = max(1, round(traffic["rate_pairs_per_s"] * seconds))
        reqs = open_loop(server, len(pool),
                         due_times(traffic["arrivals_seed"], count, seconds))
    _sync(device)
    for req in reqs:
        req.pixels = pixels
    run.requests = reqs
    run.window = (t0, max([t0] + [r.t_done for r in reqs
                                  if not math.isnan(r.t_done)]))
    if device.startswith("cuda"):
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    if launches is not None:
        run.launches = launches.snapshot()

    if trace:
        from portbench.trace import Profiler

        cuda = device.startswith("cuda")
        path = str(ROOT / "build" / "portbench" / "trace.json")
        first = len(reqs)

        def stretch(count: int, host: bool):
            nonlocal first
            profiler = Profiler(path, cuda=cuda, host=host)
            profiler.start()
            if traffic["loop"] == "closed":
                done = closed_loop(server, len(pool), 0.0, first, count)
            else:
                done = open_loop(server, len(pool), due_times(
                    traffic["arrivals_seed"] + 1, count,
                    count / traffic["rate_pairs_per_s"]), first)
            _sync(device)
            first += len(done)
            return done, profiler.stop()

        # the device's stretch records no host operator, so the host's
        # enqueue runs at its untraced speed; a short second stretch
        # records the host too, to name what the host did in each gap
        run.stretch, run.trace = stretch(config["trace_pairs"], not cuda)
        run.host_trace = (stretch(min(HOST_TRACE_PAIRS,
                                      config["trace_pairs"]), True)[1]
                          if cuda else run.trace)
    del server, pipeline
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return run, (weights, biases), pool


# ---- the comparison -----------------------------------------------------------

def compare(run: Run, weights, pool: list, seed: int, device: str) -> dict:
    """The plain reference on a sample of the pool, against every map the
    window produced for those pairs: {number: value}. ``bad_pct`` is the
    worst share, in %, of a map's pixels more than ``CHECK_GAP_PX`` from
    the reference's; ``mean_abs_px`` the worst mean distance. A window
    that made no map of the sample fails both."""
    import torch

    config = run.config
    reference = load_module(
        BENCH / "reference" / f"{config['reference']}.py",
        "portbench_reference_" + config["reference"])
    outputs: dict = {}
    for req in run.requests:
        if req.output is not None:
            outputs.setdefault(req.pool, []).append(req.output)
    bad, mean_abs, compared = 0.0, 0.0, 0
    for index in check_sample(seed, pool, config["check_pairs"]):
        maps = outputs.get(index, [])
        distinct = []
        for out in maps:
            if not any(np.array_equal(out, d) for d in distinct):
                distinct.append(out)
        if not distinct:
            continue
        pair = pool[index]
        t0 = time.perf_counter()
        ref = reference.match(
            weights[0], weights[1], pair["left"], pair["right"],
            config["ndisp"], config["match"], config["pipeline"]["bucket"],
            config["pipeline"]["volume_dtype"], device)
        print(f"reference: pair {index} ({pair['family']}) in "
              f"{time.perf_counter() - t0:.1f} s, {len(maps)} maps of it "
              f"in the window, {len(distinct)} distinct", file=sys.stderr,
              flush=True)
        for out in distinct:
            gap = np.abs(out.astype(np.float64) - ref)
            bad = max(bad, 100.0 * float(np.mean(gap > CHECK_GAP_PX)))
            mean_abs = max(mean_abs, float(np.mean(gap)))
            compared += 1
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
    if not compared:
        return {"bad_pct": 100.0, "mean_abs_px": UNCOMPARED_PX}
    return {"bad_pct": bad, "mean_abs_px": mean_abs}


def count_failed(run: Run) -> int:
    """Requests that raised, never came, or came back of the wrong shape or
    with a non-finite pixel."""
    shape = (run.config["height"], run.config["width"])
    failed = 0
    for req in run.requests:
        out = req.output
        if (req.error or out is None or out.shape != shape
                or not np.isfinite(out).all()):
            failed += 1
    return failed


def result(run: Run, numbers: dict, trace: bool, device_name: str) -> dict:
    """The result line: metrics read by their readers, the comparison's
    numbers beside their limits under ``checks``, last."""
    entries = run.cell.per_layer if trace else run.cell.end_to_end
    metrics = {}
    for entry in entries:
        value = metric_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    limits = run.config["limits"]
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in limits.items()}
    failed = count_failed(run)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    line = {"correct": correct, "attempted": len(run.requests),
            "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu", "kind": device_name,
                       "count": run.cell.chips,
                       "memory_peak_bytes": run.memory_peak_bytes}}
    if trace and run.trace is not None:
        from portbench.trace import breakdown, busy_seconds

        line["device"]["busy_s"] = busy_seconds(run.trace)
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = breakdown(run.trace, run.host_trace)
    line["checks"] = checks
    return line


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
