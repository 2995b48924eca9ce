"""The single-replica inference engine: queue → batcher → one ServeReplica
(port of `tpu_dp.serve.engine`).

    submit() → RequestQueue → DynamicBatcher → per-bucket serve program
    (`tpu_dp_torch.train.step.make_serve_step`; on a card a CUDA graph
    captured at warmup) → resolve handles

The engine is a thin façade over the same `ServeReplica` core the
multi-replica `tpu_dp_torch.serve.router.ServeCluster` fans out: it owns
the admission edge (a `RequestQueue` with SLO classes and typed shedding)
and the shared books (span recorder, per-class latency book); the replica
owns its copy of the model on its device, its stream, the per-bucket
programs behind `RecompileGuard`s (``on_retrace="raise"`` by default: a
capture after warmup means a shape or a buffer leaked past the batcher),
the dispatch thread, heartbeats and fault injection. `swap_model`
hot-swaps a new weight version between batches — zero dropped requests,
every response stamped with the version that served it.

Telemetry: per-request spans ``queue_wait / batch_form / h2d / device /
d2h`` (+ ``total``) in a `SpanRecorder`; counters ``serve.accepted /
serve.shed[.reason] / serve.completed / serve.deadline_missed /
serve.batches`` (+ per-class ``.c<k>`` twins), the
``serve.batch_occupancy`` and ``serve.device_util[.b<bucket>]`` gauges in
the process-wide registry; per-batch heartbeats via `HeartbeatWriter`
when ``obs_dir`` is set. The deterministic fault injector
(``TPU_DP_FAULT=delay:…``) is consulted per batch inside the device span,
so injected stragglers surface in spans and heartbeats like real ones.

`InferenceEngine.from_checkpoint` serves a training checkpoint of either
package, params-only (`tpu_dp_torch.checkpoint.load_params_only`: the
payload is verified, the optimizer state never converted);
`swap_from_checkpoint` swaps one in through the same loader.
"""

from __future__ import annotations

import numpy as np

from tpu_dp_torch.data.cifar import IMAGE_SHAPE
from tpu_dp_torch.obs.counters import Counters, counters as _global_counters
from tpu_dp_torch.obs.spans import SpanRecorder
from tpu_dp_torch.parallel.dist import resolve_device
from tpu_dp_torch.serve.batcher import BucketLadder
from tpu_dp_torch.serve.queue import (
    SHED_CLOSED, RequestHandle, RequestQueue, shed_counted,
)
from tpu_dp_torch.serve.replica import (
    SERVE_SPANS, LatencyBook, ServeReplica, serve_report_core,
)

__all__ = ["SERVE_SPANS", "InferenceEngine", "register_serve_costs"]


def register_serve_costs(ladder: BucketLadder, world: int,
                         model_name: str = "",
                         flops_per_image: float | None = None
                         ) -> dict[int, float]:
    """Per-bucket serve FLOPs: registered in the shared cost registry AND
    returned for the replicas' own utilization gauges.

    Forward-only FLOPs per image (analytic, ~training/3) times the
    bucket, per card — world-divisible buckets split the batch over the
    ``world`` cards, sub-world buckets run whole on each (in the port one
    replica drives one card: world 1). Unknown models publish nothing:
    absence means "not measured", never a fake number. The returned dict
    (bucket → per-card FLOPs) is what each replica computes its gauges
    from: the registry entry is introspection metadata.
    """
    from tpu_dp_torch.obs import costs as _costs

    if flops_per_image is None and model_name:
        flops_per_image = _costs.serve_flops_per_image(model_name)
    if not flops_per_image:
        return {}
    out: dict[int, float] = {}
    for b in ladder.buckets:
        per_chip = (
            float(flops_per_image) * b / world
            if b % world == 0 else float(flops_per_image) * b
        )
        out[b] = per_chip
        _costs.registry.register(
            f"serve_step@b{b}", per_chip,
            source="analytic", check="unverified",
        )
    return out


class InferenceEngine:
    """Batched-inference engine on one device (module docstring): serves
    CIFAR-shaped uint8 images ``[n, 32, 32, 3]``.

    ``device`` defaults to the CUDA card and raises without one; the tests
    pass ``device="cpu"``.
    """

    def __init__(
        self,
        model,
        device=None,
        buckets=None,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        slo_ms: float = 50.0,
        shed_headroom_ms: float = 0.0,
        obs_dir: str | None = None,
        span_capacity: int = 4096,
        on_retrace: str = "raise",
        fault: str = "",
        registry: Counters | None = None,
        model_name: str = "",
        flops_per_image: float | None = None,
        peak_flops: float | None = None,
        class_slo_ms: dict[int, float] | None = None,
        profile_dir: str = "",
        profile_batches: tuple[int, int] | None = None,
    ):
        self.device = resolve_device(device)
        self.ladder = BucketLadder(
            buckets if buckets is not None else BucketLadder().buckets
        )
        self.slo_ms = float(slo_ms)
        self.class_slo_ms = dict(class_slo_ms or {})
        self._counters = _global_counters if registry is None else registry
        self.queue = RequestQueue(
            max_depth=max_queue,
            default_slo_ms=slo_ms,
            shed_headroom_ms=shed_headroom_ms,
            image_shape=IMAGE_SHAPE,
            image_dtype=np.uint8,
            max_request=self.ladder.max_batch,
            registry=self._counters,
        )
        self.recorder = SpanRecorder(capacity=span_capacity)
        self.latency_book = LatencyBook(capacity=span_capacity)
        hb = None
        if obs_dir:
            from tpu_dp_torch.obs.health import HeartbeatWriter

            hb = HeartbeatWriter(obs_dir, rank=0)
        bucket_flops = register_serve_costs(
            self.ladder, 1, model_name=model_name,
            flops_per_image=flops_per_image,
        )
        self.replica = ServeReplica(
            sid=0,
            model=model,
            device=self.device,
            ladder=self.ladder,
            queue=self.queue,
            recorder=self.recorder,
            latency_book=self.latency_book,
            max_wait_ms=max_wait_ms,
            on_retrace=on_retrace,
            fault=fault,
            hb=hb,
            router=None,
            peak_flops=peak_flops,
            bucket_flops=bucket_flops,
            registry=self._counters,
            profile_dir=profile_dir,
            profile_batches=profile_batches,
        )
        self.batcher = self.replica.batcher
        self.model = self.replica.model
        self.num_classes = self.replica.num_classes
        self._published_version = self.replica.model_version

    @property
    def model_version(self) -> int:
        return self.replica.model_version

    @property
    def retraces(self) -> int:
        """Post-warmup retraces across every bucket program (must stay 0)."""
        return self.replica.retraces

    def guard_stats(self) -> list[dict]:
        return self.replica.guard_stats()

    def device_stats(self) -> dict:
        """The served books, fetched from the device: ground truth."""
        return self.replica.device_stats()

    # -- hot swap --------------------------------------------------------

    def swap_model(self, state_dict, version: int | None = None) -> int:
        """Hot-swap the served weights (a state dict of the served model,
        e.g. `tpu_dp_torch.compat.convert_variables` of JAX variables)
        between batches. Returns the version now pending; versions count
        published swaps."""
        self._published_version = (self._published_version + 1
                                   if version is None else int(version))
        self.replica.set_pending_state(state_dict, self._published_version)
        return self._published_version

    def swap_from_checkpoint(self, ckpt_dir,
                             version: int | None = None) -> int:
        """`swap_model` from a training checkpoint (params-only load —
        optimizer state and error-feedback residuals never materialize)."""
        return self.swap_model(_load_swap_checkpoint(ckpt_dir, self.model),
                               version=version)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "InferenceEngine":
        """Launch the dispatch thread, which first builds every bucket's
        program (per-bucket ms in ``replica.warmup_ms``) and returns when
        that warmup is done. The warmup runs on the dispatch thread because
        cuDNN's plans are cached per thread."""
        if self.replica.status == "running":
            raise RuntimeError("engine already started")
        self.replica.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Close admission; drain (default) or abandon the queue; join.

        ``drain=False`` sheds everything still pending with reason
        ``closed``. Re-raises a dispatch-thread failure.
        """
        self.queue.close()
        if not drain:
            self.replica.stop_now()
        self.replica.join()
        if not drain:
            reqs, _ = self.queue.collect(self.ladder.max_batch * 10**6)
            for req in reqs:
                shed_counted(self._counters, req.handle, SHED_CLOSED)
        if self.replica._hb is not None:
            self.replica._hb.close()
        err = self.replica.take_error()
        if err is not None:
            raise RuntimeError("serve dispatch thread failed") from err

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- producer API ----------------------------------------------------

    def submit(self, images, slo_ms: float | None = None,
               slo_class: int = 0) -> RequestHandle:
        """Enqueue one request (see `RequestQueue.submit`); may shed."""
        if slo_ms is None:
            slo_ms = self.class_slo_ms.get(int(slo_class))
        return self.queue.submit(images, slo_ms=slo_ms, slo_class=slo_class)

    # -- reporting -------------------------------------------------------

    def report(self) -> dict:
        """SLO attainment + latency percentiles + shed/bucket accounting,
        from the per-request span records (a ring of the last
        ``span_capacity``)."""
        out = serve_report_core(
            self.recorder, self.latency_book, self.replica._books_lock,
            self.class_slo_ms, self.slo_ms, self._counters,
        )
        snap = self.replica.snapshot()
        out.update({
            "batches": snap["batches"],
            "bucket_counts": snap["bucket_counts"],
            "retraces": self.retraces,
            "guards": self.guard_stats(),
            "device_stats": self.device_stats(),
            "model_version": self.replica.model_version,
            "world": 1,
            "device": str(self.device),
        })
        return out

    # -- constructors ----------------------------------------------------

    @classmethod
    def from_serve_config(cls, model, serve_cfg, **kwargs):
        """Build from a `tpu_dp_torch.config.ServeConfig` section."""
        from tpu_dp_torch.config import parse_class_slo_ms
        from tpu_dp_torch.serve.batcher import parse_buckets
        from tpu_dp_torch.utils.profiling import parse_profile_steps

        profile_batches = parse_profile_steps(serve_cfg.profile_batches)
        if profile_batches is not None and not serve_cfg.profile_dir:
            raise ValueError(
                "serve.profile_batches needs serve.profile_dir for the "
                "trace output"
            )
        return cls(
            model,
            buckets=parse_buckets(serve_cfg.buckets),
            max_wait_ms=serve_cfg.max_wait_ms,
            max_queue=serve_cfg.max_queue,
            slo_ms=serve_cfg.slo_ms,
            shed_headroom_ms=serve_cfg.shed_headroom_ms,
            obs_dir=serve_cfg.obs_dir or None,
            class_slo_ms=parse_class_slo_ms(serve_cfg.class_slo_ms),
            profile_dir=serve_cfg.profile_dir,
            profile_batches=profile_batches,
            **kwargs,
        )

    @classmethod
    def from_checkpoint(cls, ckpt_dir, model=None, **kwargs):
        """Serve a training checkpoint: ``ckpt_dir`` is one ``step_*``
        directory or a `CheckpointManager` root (its newest complete
        save). Without ``model`` the model is rebuilt from the meta's
        ``config``: ``resnet18`` or ``resnet50`` with every stage on the
        fused kernel (the port's serve path), ``net`` as it is; its
        classes from the config (or its dataset). ``kwargs`` go to the
        engine."""
        model, name = _resolve_checkpoint(ckpt_dir, model)
        if name:
            kwargs.setdefault("model_name", name)
        return cls(model, **kwargs)


def _resolve_checkpoint(ckpt_dir, model):
    """``(model, model_name)`` from a training checkpoint dir or
    CheckpointManager root, the model holding its weights — the shared
    loader behind `InferenceEngine.from_checkpoint` and
    `ServeCluster.from_checkpoint` (``model_name`` is "" when the caller
    passed the model)."""
    from tpu_dp_torch.checkpoint import read_meta, resolve_ckpt_dir
    from tpu_dp_torch.models import build_model

    ckpt_dir = resolve_ckpt_dir(ckpt_dir)
    name = ""
    if model is None:
        cfg = read_meta(ckpt_dir).get("config", {})
        model_cfg = cfg.get("model", {})
        name = model_cfg.get("name", "net")
        num_classes = model_cfg.get("num_classes") or (
            100 if cfg.get("data", {}).get("dataset") == "cifar100"
            else 10)
        model = build_model(name, num_classes=num_classes,
                            fused_stages=(0, 1, 2, 3))
    model.load_state_dict(_load_swap_checkpoint(ckpt_dir, model),
                          strict=True)
    return model, name


def _load_swap_checkpoint(ckpt_dir, model) -> dict:
    """Params-only restore as a state dict of ``model`` (f32 CPU tensors;
    every key and shape checked against it): a step dir or a
    CheckpointManager root, like `from_checkpoint`."""
    from tpu_dp_torch.checkpoint import load_params_only, resolve_ckpt_dir
    from tpu_dp_torch.compat import check_state_dict, convert_variables

    params, batch_stats, _ = load_params_only(resolve_ckpt_dir(ckpt_dir))
    state = convert_variables({"params": params,
                               "batch_stats": batch_stats})
    check_state_dict(model, state)
    return state
