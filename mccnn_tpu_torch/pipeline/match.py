"""The matching pipeline on PyTorch (mccnn_tpu/pipeline/match.py).

features -> cost volume -> CBCA (iters_1) -> SGM -> CBCA (iters_2) -> WTA
-> LR-consistency interpolation -> subpixel -> 5x5 median -> 5x5 bilateral.
With the band kernels (``cost_volume_method`` "auto" or "pallas") one volume
is built and processed at a time, right volume first (it reduces to its
disparity map before the left one, which lives on through subpixel, is
built): peak memory is one volume plus the CBCA buffers. With "matmul" or
"rolldot" both volumes are built at once and the left is processed first, as
the JAX package does. ``MatchPipeline.stage_times`` runs the same stages as
ten separately timed steps with both volumes live.

On a CUDA device the cost volume, CBCA rounds and SGM sweeps run the
port's kernels (``csrc/``): K1 (one band side) or K5 (both sides, in
``stage_times``), K3 (with ``MatchConfig.sgm_u8`` on precomputed penalty
codes) and, by ``cbca_impl``: K2 ("auto", "fused", "xla"; "fused16" with
bf16-rounded operands), K7 ("pallas": exact f32, single pass), K4
("fused8": int8 storage), K8 ("rolling", "rolling16": rows rolled through a
ring) and K9 ("fused2", "fused2_16": two rounds per pass; an odd round on
K2). "mxu" (banded 0/1 matrix products, ``ops/cbca_mxu.py``) and
``MatchConfig.cbca_joint_regions`` (``ops/cbca_joint.py``) are torch ops on
any device, as they are plain XLA in the JAX package. On the CPU every
kernel's wrapper runs its plain version; nothing selects a plain version
for a CUDA tensor.

f32 convolutions and matrix products must not run in TF32 on the card
(cuDNN allows it by default), so ``match_pair`` switches TF32 off for
cuDNN and cuBLAS before it runs.

While tracing is on (``utils/tracing.py``: a torch profiler recording, or
``tracing.enable()``), ``match_pair`` records a span for each stage:
``features``, ``cost_volume`` (the band and its border fills), ``cbca``
(the arms and one CBCA stage, chunk copies included), ``sgm`` and
``post`` (the WTAs, the LR check, subpixel and both filters), the volume
stages once a side, inside ``MatchPipeline``'s ``dispatch`` span beside
``copy_in``; ``fetch`` records ``copy_out``. The set-up spans are recorded
always.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from mccnn_tpu_torch.models.net import (
    FeatureNet,
    disable_tf32,
    extract_features,
    params_from_numpy,
)
from mccnn_tpu_torch.ops.cbca import compute_arms
from mccnn_tpu_torch.ops.cbca_fused import cbca_fused
from mccnn_tpu_torch.ops.cbca_fused2 import cbca_fused_two
from mccnn_tpu_torch.ops.cbca_joint import cbca_joint
from mccnn_tpu_torch.ops.cbca_mxu import build_masks, cbca_mxu
from mccnn_tpu_torch.ops.cbca_pallas import cbca_pallas
from mccnn_tpu_torch.ops.cbca_rolling import cbca_fused_rolling
from mccnn_tpu_torch.ops.cost_volume import cost_volume_pair
from mccnn_tpu_torch.ops.filters import bilateral_filter, median_filter
from mccnn_tpu_torch.ops.lr_check import lr_consistency_interpolate
from mccnn_tpu_torch.ops.sgm import _sgm_one_volume
from mccnn_tpu_torch.ops.subpixel import subpixel_enhance
from mccnn_tpu_torch.ops.wta import wta_disparity
from mccnn_tpu_torch.utils import tracing
from mccnn_tpu_torch.utils.config import MatchConfig

_VOLUME_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the JAX package's CBCA names; "auto" is K2's exact f32 sums ("xla")
_CBCA_IMPLS = ("auto", "mxu", "fused", "fused16", "fused8", "fused2",
               "fused2_16", "pallas", "xla", "rolling", "rolling16")
_COST_VOLUME_METHODS = ("auto", "pallas", "matmul", "rolldot")
STAGES = ("features", "cost_volume", "cbca_1", "sgm", "cbca_2", "wta",
          "lr_interpolation", "subpixel", "median", "bilateral")


def _check_options(config: MatchConfig, volume_dtype: str, cbca_impl: str,
                   cost_volume_method: str = "auto") -> None:
    """Raise for option values that neither package knows or takes."""
    if volume_dtype not in _VOLUME_DTYPES:
        raise ValueError(f"volume_dtype must be one of {tuple(_VOLUME_DTYPES)}")
    if cbca_impl not in _CBCA_IMPLS:
        raise ValueError(
            f"unknown cbca_impl {cbca_impl!r}; use one of {_CBCA_IMPLS}")
    if cbca_impl in ("pallas", "mxu") and volume_dtype != "float32":
        raise ValueError(
            f"cbca_impl {cbca_impl!r} takes float32 volumes only")
    if cost_volume_method not in _COST_VOLUME_METHODS:
        raise ValueError(
            f"unknown cost-volume method: {cost_volume_method!r}; use one of "
            f"{_COST_VOLUME_METHODS}")


def _cbca_aggregate(cbca_impl: str):
    """A CBCA impl name -> ``fn(volume, arms, iterations, distance)``
    (mccnn_tpu/pipeline/match.py::_cbca_aggregate); "mxu" also takes
    ``masks=``."""
    bf16_operands = {"compute_dtype": torch.bfloat16}
    return {
        "pallas": cbca_pallas,
        "mxu": cbca_mxu,
        "fused16": functools.partial(cbca_fused, **bf16_operands),
        "fused2": cbca_fused_two,
        "fused2_16": functools.partial(cbca_fused_two, **bf16_operands),
        "fused8": functools.partial(cbca_fused, int8_storage=True),
        "rolling": cbca_fused_rolling,
        "rolling16": functools.partial(cbca_fused_rolling, **bf16_operands),
    }.get(cbca_impl, cbca_fused)


def _run_cbca(aggregate, volume: torch.Tensor, arms, iterations: int,
              distance: int, cbca_chunk_d: int, **kwargs) -> torch.Tensor:
    """Aggregate the whole volume, or slices of its disparity axis in turn.

    Aggregation is independent per disparity, so chunking caps the round
    buffers at the chunk size. A slice of the last axis is not contiguous
    and the kernels want contiguous operands, so each chunk is copied out,
    aggregated and written back into ``volume`` in place. With "fused8"
    every chunk call quantizes by its own scale, as in the JAX package.
    """
    d_pad = volume.shape[2]
    if not cbca_chunk_d or d_pad <= cbca_chunk_d:
        return aggregate(volume, arms, iterations, distance, **kwargs)
    if d_pad % cbca_chunk_d:
        raise ValueError("cbca_chunk_d must divide the padded depth")
    for start in range(0, d_pad, cbca_chunk_d):
        block = volume[:, :, start:start + cbca_chunk_d].contiguous()
        volume[:, :, start:start + cbca_chunk_d] = aggregate(
            block, arms, iterations, distance, **kwargs)
    return volume


def _post_stages(ndisp: int, config: MatchConfig, rows=None):
    """The four post-WTA stages as (name, fn(state) -> state) steps.

    The state holds ``left`` (the image), ``left_disparity``,
    ``right_disparity`` and ``left_volume``; each step drops what no later
    step reads and leaves its result under ``disparity``. With ``rows``
    (see ``match_pair``) the left volume is a row shard: subpixel runs on
    its rows of the map, and the map is gathered again.
    """

    def lr_interpolation(s):
        s["disparity"] = lr_consistency_interpolate(
            s.pop("left_disparity"), s.pop("right_disparity"), ndisp)
        return s

    def subpixel(s):
        if rows is None:
            s["disparity"] = subpixel_enhance(s["disparity"],
                                              s.pop("left_volume"), ndisp)
        else:
            s["disparity"] = rows.gather(subpixel_enhance(
                rows.local(s["disparity"]), s.pop("left_volume"), ndisp))
        return s

    def median(s):
        s["disparity"] = median_filter(
            s["disparity"], config.median_filter_size,
            config.median_filter_size)
        return s

    def bilateral(s):
        s["disparity"] = bilateral_filter(
            s["left"], s["disparity"], config.bilateral_filter_size,
            config.bilateral_filter_size, 0.0, config.blur_sigma,
            config.blur_threshold)
        return s

    return list(zip(STAGES[6:], (lr_interpolation, subpixel, median,
                                 bilateral)))


def match_pair(net: FeatureNet, left_image: torch.Tensor,
               right_image: torch.Tensor, ndisp: int,
               config: MatchConfig = MatchConfig(),
               volume_dtype: str = "float32", cbca_impl: str = "auto",
               return_volumes: bool = False, cbca_chunk_d: int = 0,
               cost_volume_method: str = "auto", cost_volume_fn=None,
               cbca_fn=None, cbca_joint_fn=None, sgm_fn=None, rows=None):
    """(H, W) standardized image pair -> (H, W) float32 disparity map.

    ``volume_dtype`` "bfloat16" stores the volumes in bf16 (the descriptors
    are cast to bf16 for the band kernels; DP and aggregation math stay
    f32). ``cbca_impl`` "auto", "fused" and "xla" aggregate with
    ``cbca_fused`` (K2 on CUDA, which sums in f32 like JAX's exact "xla"
    path), "pallas" with ``cbca_pallas`` (K7, f32 volumes only), "fused8"
    with int8 storage (K4), "rolling" with ``cbca_fused_rolling`` (K8),
    "fused2" with ``cbca_fused_two`` (K9) and "mxu" with ``cbca_mxu``
    (f32 volumes only; its masks are built once per volume); "fused16",
    "rolling16" and "fused2_16" are the f32-storage modes that round the
    rounds' operands to bf16. On the CPU each kernel runs its plain
    version. ``config.cbca_joint_regions`` aggregates with ``cbca_joint``
    over disparity-conditioned regions instead, whatever ``cbca_impl``
    says, and ``config.sgm_u8`` feeds the sweeps precomputed penalty codes
    (the same result). ``cbca_chunk_d`` aggregates the disparity axis in chunks of
    that many lanes. ``cost_volume_method`` "auto" and "pallas" build one
    volume at a time with K1, right first; "matmul" and "rolldot" build both
    with torch ops and process the left first. ``return_volumes=True``
    returns a dict with the disparity, the processed pre-WTA volumes and
    the per-side WTA maps.

    The hooks are how ``parallel/match.py`` runs the stages on row shards
    (the JAX package's ``cost_volume_fn`` and ``cbca_fn``, and what GSPMD
    does there without a hook): ``cost_volume_fn(features_left,
    features_right, sides)`` builds one volume from the whole descriptor
    maps, and the volumes are then built one at a time, right first,
    whatever the method; ``cbca_fn(volume, arms, iterations)`` aggregates
    with the whole image's arms (``cbca_chunk_d`` and the joint regions
    are not read, as under the JAX package's ``cbca_fn``);
    ``cbca_joint_fn`` takes ``cbca_joint``'s arguments and runs in its
    place with ``config.cbca_joint_regions``; ``sgm_fn`` takes
    ``_sgm_one_volume``'s arguments; and
    ``rows`` has ``gather(local)``, the whole map from every rank's rows,
    and ``local(whole)``, this rank's rows: the WTA maps are gathered
    before the LR check, which reads across rows, and subpixel runs on the
    shard. With ``return_volumes`` the volumes are then this rank's rows
    and the maps whole.
    """
    _check_options(config, volume_dtype, cbca_impl, cost_volume_method)
    disable_tf32()
    vdtype = _VOLUME_DTYPES[volume_dtype]
    distance = int(config.cbca_distance)
    aggregate = _cbca_aggregate(cbca_impl)
    band_kernels = cost_volume_method in ("auto", "pallas")
    if sgm_fn is None:
        sgm_fn = _sgm_one_volume
    wta = wta_disparity if rows is None else (
        lambda volume: rows.gather(wta_disparity(volume)))

    with torch.no_grad():
        with tracing.span("features"):
            features_left = extract_features(net, left_image)
            features_right = extract_features(net, right_image)
            if band_kernels and vdtype == torch.bfloat16:
                features_left = features_left.to(torch.bfloat16)
                features_right = features_right.to(torch.bfloat16)

        def process(volume: torch.Tensor, image: torch.Tensor,
                    choice: str) -> torch.Tensor:
            """CBCA -> SGM -> CBCA for one volume."""
            with tracing.span("cbca"):
                arms = compute_arms(image, config.cbca_intensity, distance)
                if cbca_fn is not None:
                    def run(volume, iterations):
                        return cbca_fn(volume, arms, iterations)
                elif config.cbca_joint_regions:
                    other = right_image if choice == "L" else left_image
                    arms_other = compute_arms(other, config.cbca_intensity,
                                              distance)
                    joint = (cbca_joint if cbca_joint_fn is None
                             else cbca_joint_fn)

                    def run(volume, iterations):
                        return joint(volume, arms, arms_other, iterations,
                                     distance, ndisp, choice)
                else:
                    # the "mxu" mask stacks serve both CBCA stages of a volume
                    kwargs = ({"masks": build_masks(arms)}
                              if cbca_impl == "mxu" else {})

                    def run(volume, iterations):
                        return _run_cbca(aggregate, volume, arms, iterations,
                                         distance, cbca_chunk_d, **kwargs)

                volume = run(volume, config.cbca_num_iterations_1)
            with tracing.span("sgm"):
                volume = sgm_fn(volume, left_image, right_image, choice,
                                ndisp, config)
            with tracing.span("cbca"):
                return run(volume, config.cbca_num_iterations_2)

        if band_kernels or cost_volume_fn is not None:
            if cost_volume_fn is None:
                def cost_volume_fn(fl, fr, sides):
                    return cost_volume_pair(fl, fr, ndisp, sides=sides,
                                            dtype=vdtype)

            def build(sides):
                # no name holds the raw volume while ``process`` runs
                with tracing.span("cost_volume"):
                    return cost_volume_fn(features_left, features_right,
                                          sides)

            right_volume = process(build("right"), right_image, "R")
            with tracing.span("post"):
                right_disparity = wta(right_volume)
            if not return_volumes:
                del right_volume  # free it before the left volume is built
            left_volume = process(build("left"), left_image, "L")
            with tracing.span("post"):
                left_disparity = wta(left_volume)
        else:
            with tracing.span("cost_volume"):
                left_volume, right_volume = cost_volume_pair(
                    features_left, features_right, ndisp, dtype=vdtype,
                    method=cost_volume_method)
            left_volume = process(left_volume, left_image, "L")
            right_volume = process(right_volume, right_image, "R")
            with tracing.span("post"):
                left_disparity = wta(left_volume)
                right_disparity = wta(right_volume)

        with tracing.span("post"):
            state = {"left": left_image, "left_volume": left_volume,
                     "left_disparity": left_disparity,
                     "right_disparity": right_disparity}
            for _, stage in _post_stages(ndisp, config, rows):
                state = stage(state)
            disparity = state["disparity"]
    if return_volumes:
        return {
            "disparity": disparity,
            "left_volume": left_volume,
            "right_volume": right_volume,
            "left_disparity": left_disparity,
            "right_disparity": right_disparity,
        }
    return disparity


def _build_staged(net: FeatureNet, config: MatchConfig, ndisp: int,
                  cost_volume_method: str, cbca_impl: str, volume_dtype: str,
                  cbca_chunk_d: int):
    """The pipeline as ten (name, fn(state) -> state) steps, in ``STAGES``
    order, for ``MatchPipeline.stage_times``.

    The same operations as ``match_pair``, but both volumes are built in
    one step (kernel K5 with the band methods) and stay live side by side.
    As in the JAX package, joint-region CBCA is not supported in this mode
    (``config.cbca_joint_regions`` is not read) and "mxu" builds its masks
    in every CBCA call.
    """
    vdtype = _VOLUME_DTYPES[volume_dtype]
    distance = int(config.cbca_distance)
    aggregate = _cbca_aggregate(cbca_impl)
    band_kernels = cost_volume_method in ("auto", "pallas")

    def features(s):
        s["features_left"] = extract_features(net, s["left"])
        s["features_right"] = extract_features(net, s["right"])
        return s

    def cost_volume(s):
        fl, fr = s.pop("features_left"), s.pop("features_right")
        if band_kernels and vdtype == torch.bfloat16:
            fl, fr = fl.to(torch.bfloat16), fr.to(torch.bfloat16)
        s["left_volume"], s["right_volume"] = cost_volume_pair(
            fl, fr, ndisp, dtype=vdtype, method=cost_volume_method)
        return s

    def make_cbca(iterations):
        def stage(s):
            for side in ("left", "right"):
                arms = compute_arms(s[side], config.cbca_intensity, distance)
                s[f"{side}_volume"] = _run_cbca(
                    aggregate, s[f"{side}_volume"], arms, iterations,
                    distance, cbca_chunk_d)
            return s

        return stage

    def sgm_stage(s):
        for side, choice in (("left", "L"), ("right", "R")):
            s[f"{side}_volume"] = _sgm_one_volume(
                s[f"{side}_volume"], s["left"], s["right"], choice, ndisp,
                config)
        return s

    def wta(s):
        s["left_disparity"] = wta_disparity(s["left_volume"])
        s["right_disparity"] = wta_disparity(s.pop("right_volume"))
        return s

    stages = [features, cost_volume, make_cbca(config.cbca_num_iterations_1),
              sgm_stage, make_cbca(config.cbca_num_iterations_2), wta]
    return list(zip(STAGES, stages)) + _post_stages(ndisp, config)


def standardize_image(image: np.ndarray) -> np.ndarray:
    """(x - mean) / std over the whole image."""
    image = image.astype(np.float32)
    return (image - image.mean()) / image.std()


class MatchPipeline:
    """Host-facing wrapper: bucket padding, device transfer, cropping.

    Images are padded in edge mode up to multiples of ``bucket`` (as the
    JAX pipeline does, so both produce the same disparities); the output
    is cropped back. ``device`` is explicit: a CUDA request with no card
    raises.
    """

    def __init__(self, params, config: MatchConfig = MatchConfig(),
                 bucket: int = 64, volume_dtype: str = "float32",
                 cbca_impl: str = "auto", cbca_chunk_d: int = 0,
                 device: str = "cuda", cost_volume_method: str = "auto"):
        _check_options(config, volume_dtype, cbca_impl, cost_volume_method)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        with tracing.setup_span("pipeline"):
            net = params if isinstance(params, FeatureNet) else (
                params_from_numpy(params))
            self.net = net.to(self.device)
        self.config = config
        self.bucket = bucket
        self.volume_dtype = volume_dtype
        self.cbca_impl = cbca_impl
        self.cbca_chunk_d = cbca_chunk_d
        self.cost_volume_method = cost_volume_method
        self._shapes = set()  # (height, width, ndisp) of the buckets met

    def _bucketed(self, size: int) -> int:
        return -(-size // self.bucket) * self.bucket

    def dispatch(self, left_image: np.ndarray, right_image: np.ndarray,
                 ndisp: int):
        """Pad, copy in and enqueue the pipeline; no device sync.

        Pair with ``fetch``: the serve loop dispatches scene N, then writes
        scene N-1's artifacts while N runs on the card. The handle carries
        the pair's id for the spans of ``utils/tracing.py`` and whether the
        pair is its bucket shape's first: that pair's dispatch and fetch are
        each a ``setup.first_pair`` span (the caller's time between them is
        not).
        """
        shape = (self._bucketed(left_image.shape[0]),
                 self._bucketed(left_image.shape[1]), ndisp)
        first = shape not in self._shapes
        if first:
            self._shapes.add(shape)
            start = time.perf_counter()
        pair = tracing.new_pair()
        with tracing.span("dispatch", pair):
            with tracing.span("copy_in"):
                left, right = self._padded_on_device(left_image, right_image)
            out = match_pair(
                self.net, left, right, ndisp, self.config,
                volume_dtype=self.volume_dtype, cbca_impl=self.cbca_impl,
                cbca_chunk_d=self.cbca_chunk_d,
                cost_volume_method=self.cost_volume_method,
            )
        if first:
            tracing.add("setup.first_pair", start, time.perf_counter(), pair)
        return out, left_image.shape, pair, first

    def _padded_on_device(self, left_image: np.ndarray,
                          right_image: np.ndarray):
        """Edge-pad the pair up to the bucket and copy it to the device."""
        height, width = left_image.shape
        pad_h = self._bucketed(height) - height
        pad_w = self._bucketed(width) - width
        if pad_h or pad_w:
            pad = ((0, pad_h), (0, pad_w))
            left_image = np.pad(left_image, pad, mode="edge")
            right_image = np.pad(right_image, pad, mode="edge")
        return self._to_device(left_image), self._to_device(right_image)

    def _to_device(self, image: np.ndarray) -> torch.Tensor:
        """Host image -> device tensor without waiting for the device.

        A copy from pageable memory would synchronize the stream; a pinned
        staging copy lets it queue behind the previous scene's work.
        """
        tensor = torch.from_numpy(np.ascontiguousarray(image, np.float32))
        if self.device.type != "cuda":
            return tensor
        return tensor.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def fetch(handle) -> np.ndarray:
        """Copy the result to the host (waits for the device) and crop."""
        out, (height, width), pair, first = handle
        if first:
            start = time.perf_counter()
        with tracing.span("copy_out", pair):
            disparity = out.cpu().numpy()[:height, :width]
        tracing.resolve()
        if first:
            tracing.add("setup.first_pair", start, time.perf_counter(), pair)
        return disparity

    def __call__(self, left_image: np.ndarray, right_image: np.ndarray,
                 ndisp: int) -> np.ndarray:
        """Standardized (H, W) pair -> (H, W) disparity (host arrays)."""
        return self.fetch(self.dispatch(left_image, right_image, ndisp))

    def stage_times(self, left_image: np.ndarray, right_image: np.ndarray,
                    ndisp: int):
        """Observability mode (cli/match.py --stage_times): the pipeline as
        ten steps with a device sync after each; returns ``(disparity,
        {stage: seconds})``.

        Real data flows from stage to stage, but both volumes are live at
        once (built by one K5 launch with the band methods): it needs about
        twice ``__call__``'s memory.
        """
        disable_tf32()
        height, width = left_image.shape
        left, right = self._padded_on_device(left_image, right_image)
        stages = _build_staged(
            self.net, self.config, ndisp, self.cost_volume_method,
            self.cbca_impl, self.volume_dtype, self.cbca_chunk_d)
        state = {"left": left, "right": right}
        times = {}
        with torch.no_grad():
            for name, stage in stages:
                self._sync()
                t0 = time.perf_counter()
                state = stage(state)
                self._sync()
                times[name] = time.perf_counter() - t0
        disparity = state["disparity"].cpu().numpy()[:height, :width]
        return disparity, times

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
