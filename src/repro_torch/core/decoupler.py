"""Deep-structure decoupling: split a model at point i*, quantize the
boundary to c bits through a boundary codec, and run head (edge) / tail
(cloud) as separate steps — plus the engine that glues predictor tables,
latency model and planner into the paper's decision procedure.

The three-tier split (device -> edge server -> cloud) is here too:
:class:`TriDecoupledRunner` and the engine's ``tri_space`` /
``decide_tri``; so is token streaming: the engine's ``stream_terms`` /
``decide_streaming`` and ``DecoupledRunner.stream_session``. Not ported:
``run_simulated``, ``compress_state`` and the meshed cloud.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, List, Optional, Tuple

import torch

if TYPE_CHECKING:
    from repro_torch.codec import BoundaryCodec, WireBlob

from repro_torch.config.types import JaladConfig
from repro_torch.core.ilp import ILPProblem, solve
from repro_torch.core.latency import LatencyModel
from repro_torch.core.planner import PlanSpace, StreamPlanTerms
from repro_torch.core.predictor import PredictorTables
from repro_torch.core.tri_planner import TriPlanSpace
from repro_torch.device import tensor_device
from repro_torch.models.api import Model, batch_to
from repro_torch.models.init import torch_dtype


@dataclass
class DecoupledPlan:
    """One decision: where to cut, at what bit width, through which codec
    (``point < 0``: no cut, everything on the cloud).

    A three-tier decision fills the second cut: the device runs ``[0,
    point]``, an edge server ``(point, point2]`` and the cloud the rest,
    with the second boundary at ``bits2`` through ``codec2``. Two-tier
    plans keep the defaults (``point2 = -1``). ``point2 == point`` relays
    the device's blob through the edge server unchanged; the planner emits
    such cells only with ``bits2 == bits`` and ``codec2 == codec``."""

    point: int
    bits: int
    predicted_latency: float
    predicted_acc_drop: float
    solve_ms: float
    codec: str = "huffman"
    point2: int = -1
    bits2: int = 0
    codec2: str = ""

    @property
    def is_cloud_only(self) -> bool:
        return self.point < 0

    @property
    def has_second_cut(self) -> bool:
        return self.point2 >= 0


@dataclass
class DecoupledRunner:
    """Executable split model on the parameters' device. ``edge_step``
    runs the head and encodes the boundary (a host ``WireBlob`` — the
    link); ``cloud_step`` decodes it and finishes the inference, and
    ``cloud_step_batch`` does so for a group of blobs with one batched
    decode. The wire format is entirely the plan's codec's."""

    model: Model
    params: Any
    plan: DecoupledPlan

    def __post_init__(self):
        from repro_torch.codec import get_codec

        self._codec: "BoundaryCodec" = get_codec(self.plan.codec)
        self.device = tensor_device(self.params)
        self._dtype = torch_dtype(self.model.cfg.dtype)

    @torch.no_grad()
    def edge_step(self, batch) -> Tuple["WireBlob", Any]:
        boundary = self.model.run_head(self.params,
                                       batch_to(batch, self.device),
                                       self.plan.point)
        return self._codec.encode(boundary, self.plan.bits), None

    @torch.no_grad()
    def edge_step_batch(self, batches) -> List[Tuple["WireBlob", Any]]:
        """Heads per request, then ONE batched codec encode of the
        same-shape boundaries; each blob byte-identical to ``edge_step``."""
        heads = [self.model.run_head(self.params, batch_to(b, self.device),
                                     self.plan.point) for b in batches]
        blobs = self._codec.encode_batch(heads, self.plan.bits)
        return [(blob, None) for blob in blobs]

    @torch.no_grad()
    def cloud_step(self, blob: "WireBlob", extras=None) -> torch.Tensor:
        from repro_torch.codec import get_codec

        boundary = get_codec(blob.codec).decode(blob, out_dtype=self._dtype,
                                                device=self.device)
        return self.model.run_tail(self.params, boundary, self.plan.point)

    @torch.no_grad()
    def cloud_step_batch(self, blobs: List["WireBlob"],
                         extras_list: Optional[List[Any]] = None,
                         fuse_tail: bool = False) -> List[torch.Tensor]:
        """Batched cloud half, mirroring ``edge_step_batch``: one batched
        wire decode (``BoundaryCodec.decode_batch``, bit-identical per blob
        by the codec contract) feeding the tail forwards.

        ``fuse_tail=False`` runs each tail through the same ``run_tail``
        as :meth:`cloud_step`, so every result equals serving the blob
        alone; the decode batching still collapses B dequant launches into
        one. ``fuse_tail=True`` also concatenates the group along the batch
        axis into ONE tail forward, then splits the logits at the blobs'
        batch sizes: fastest, but equal only within float tolerance
        (convolutions pick other algorithms, and sum in another order, at
        another batch size). A group of one blob, blobs carrying
        ``extras``, mixed codecs or boundaries whose trailing dims differ
        run through the per-request :meth:`cloud_step`."""
        from repro_torch.codec import get_codec

        if extras_list is None:
            extras_list = [None] * len(blobs)
        if not blobs:
            return []
        batchable = (
            len(blobs) > 1
            and all(e is None for e in extras_list)
            and len({b.codec for b in blobs}) == 1
            and len({tuple(b.shape[1:]) for b in blobs}) == 1
            and all(len(b.shape) >= 1 for b in blobs)
        )
        if not batchable:
            return [self.cloud_step(b, e)
                    for b, e in zip(blobs, extras_list)]
        boundaries = get_codec(blobs[0].codec).decode_batch(
            blobs, out_dtype=self._dtype, device=self.device)
        if not fuse_tail:
            return [self.model.run_tail(self.params, x, self.plan.point)
                    for x in boundaries]
        logits = self.model.run_tail(self.params, torch.cat(boundaries),
                                     self.plan.point)
        return list(torch.split(logits, [int(b.shape[0]) for b in blobs]))

    def run(self, batch):
        """Full decoupled inference; returns (logits, transfer_bytes)."""
        blob, extras = self.edge_step(batch)
        return self.cloud_step(blob, extras), blob.nbytes

    def stream_session(self, serve_cfg, cloud_kv_bits: int = 8):
        """Token-level serving under this runner's plan: a
        :class:`~repro_torch.serving.streaming.TokenStreamSession` whose
        decode loop runs head on the edge, the boundary through this
        codec and the tail on the cloud every token (int8 cloud KV by
        default)."""
        from repro_torch.serving.streaming import TokenStreamSession

        return TokenStreamSession(self.model, self.params, serve_cfg,
                                  plan=self.plan,
                                  cloud_kv_bits=cloud_kv_bits)


@dataclass
class TriDecoupledRunner:
    """Executable three-way split (device -> edge server -> cloud) of a
    plan with a second cut, on the parameters' device. ``device_step``
    runs ``[0, point]`` and encodes the first boundary;
    ``edge_server_step`` decodes it, runs ``(point, point2]`` and encodes
    the second; ``cloud_step`` finishes from ``point2``. A relay plan
    (``point2 == point``) passes the device's blob on unchanged: no
    decode, no encode, no kernel launch at the edge server."""

    model: Model
    params: Any
    plan: DecoupledPlan

    def __post_init__(self):
        from repro_torch.codec import get_codec

        if not self.plan.has_second_cut:
            raise ValueError("TriDecoupledRunner needs a plan with a second "
                             "cut (point2 >= 0); use DecoupledRunner for "
                             "two-tier plans")
        if self.plan.point2 < self.plan.point:
            raise ValueError(f"cuts must be ordered, got "
                             f"({self.plan.point}, {self.plan.point2})")
        self._codec1: "BoundaryCodec" = get_codec(self.plan.codec)
        self._codec2: "BoundaryCodec" = get_codec(self.plan.codec2)
        self.device = tensor_device(self.params)
        self._dtype = torch_dtype(self.model.cfg.dtype)

    @property
    def is_relay(self) -> bool:
        return self.plan.point2 == self.plan.point

    @torch.no_grad()
    def device_step(self, batch) -> Tuple["WireBlob", Any]:
        boundary = self.model.run_head(self.params,
                                       batch_to(batch, self.device),
                                       self.plan.point)
        return self._codec1.encode(boundary, self.plan.bits), None

    @torch.no_grad()
    def edge_server_step(self, blob: "WireBlob",
                         extras=None) -> Tuple["WireBlob", Any]:
        """Middle tier: first-link blob in, second-link blob out."""
        from repro_torch.codec import get_codec

        if self.is_relay:
            return blob, extras
        boundary = get_codec(blob.codec).decode(blob, out_dtype=self._dtype,
                                                device=self.device)
        boundary2 = self.model.run_segment(self.params, boundary,
                                           self.plan.point, self.plan.point2)
        return self._codec2.encode(boundary2, self.plan.bits2), extras

    @torch.no_grad()
    def cloud_step(self, blob: "WireBlob", extras=None) -> torch.Tensor:
        from repro_torch.codec import get_codec

        boundary = get_codec(blob.codec).decode(blob, out_dtype=self._dtype,
                                                device=self.device)
        return self.model.run_tail(self.params, boundary, self.plan.point2)

    def run(self, batch):
        """Full three-hop inference; returns ``(logits, link1_bytes,
        link2_bytes)``."""
        blob1, extras = self.device_step(batch)
        blob2, extras = self.edge_server_step(blob1, extras)
        return self.cloud_step(blob2, extras), blob1.nbytes, blob2.nbytes


@dataclass
class JaladEngine:
    """Predictor tables + latency model; answers "where do we cut right
    now?" for the current bandwidth (paper Sec. III-E) through one cached
    :class:`PlanSpace`."""

    model: Model
    tables: PredictorTables
    latency: LatencyModel
    cfg: JaladConfig
    point_indices: Optional[List[int]] = None   # tables row -> model point
    _plan_space: Optional[PlanSpace] = field(
        default=None, repr=False, compare=False)
    _stream_terms: Optional[StreamPlanTerms] = field(
        default=None, repr=False, compare=False)
    _tri_space: Optional[TriPlanSpace] = field(
        default=None, repr=False, compare=False)

    @property
    def plan_space(self) -> PlanSpace:
        if self._plan_space is None:
            self._plan_space = PlanSpace.build(
                self.tables, self.latency, self.cfg.accuracy_drop_budget,
                self.point_indices,
            )
        return self._plan_space

    @property
    def tri_space(self) -> TriPlanSpace:
        """The three-tier (device -> edge server -> cloud) space over the
        same tables and latency model, with the config's edge server and
        power model. Its ``degenerate()`` view at ``BW1 = inf`` decides as
        :attr:`plan_space` does, bit for bit."""
        if self._tri_space is None:
            self._tri_space = TriPlanSpace.build(
                self.tables, self.latency, self.cfg.accuracy_drop_budget,
                edge_server=self.cfg.edge_server,
                power=self.cfg.power,
                energy_weight=self.cfg.energy_weight,
                point_indices=self.point_indices,
            )
        return self._tri_space

    def decide_tri(self, bandwidth1: Optional[float] = None,
                   bandwidth2: Optional[float] = None,
                   energy_budget: Optional[float] = None) -> DecoupledPlan:
        """Three-tier decision at the two link bandwidths (defaults from
        the config), under the config's energy budget unless one is
        given."""
        bw1 = bandwidth1 if bandwidth1 is not None else \
            self.cfg.bandwidth_bytes_per_s
        bw2 = bandwidth2 if bandwidth2 is not None else \
            self.cfg.bandwidth2_bytes_per_s
        budget = energy_budget if energy_budget is not None else \
            self.cfg.energy_budget_j
        return self.tri_space.decide(bw1, bw2, energy_budget=budget)

    def ilp_problem(self, bandwidth: float) -> ILPProblem:
        return self.plan_space.ilp_problem(bandwidth)

    def decide(self, bandwidth: Optional[float] = None,
               method: str = "planner") -> DecoupledPlan:
        """Decide (point, bits, codec) at a bandwidth. ``"planner"`` is the
        fused argmin; ``"enumeration"``/``"bnb"`` run the ILP oracles over
        the identical cost tables."""
        bw = bandwidth if bandwidth is not None else \
            self.cfg.bandwidth_bytes_per_s
        space = self.plan_space
        if method == "planner":
            return space.decide(bw)
        sol = solve(space.ilp_problem(bw), method)
        if sol is None:
            return space.cloud_only_plan(bw)
        return space.plan_from_solution(sol)

    @property
    def stream_terms(self) -> StreamPlanTerms:
        """The per-token steady-state extension of this engine's PlanSpace
        (built lazily, cached). The calibration unit is one batch of
        ``input_bytes / 4`` tokens (int32 token ids, ``input_bytes = B * S
        * 4``), which turns the per-batch FMAC time vectors into per-token
        stage times."""
        if self._stream_terms is None:
            if self.model.cfg.family == "cnn":
                raise ValueError(
                    "token streaming is autoregressive decode; CNNs "
                    "decouple per request (use decide/make_runner)")
            self._stream_terms = self.plan_space.with_streaming(
                self.model.cfg.d_model,
                self.latency.input_bytes / 4.0,
            )
        return self._stream_terms

    def decide_streaming(self, bandwidth: Optional[float] = None,
                         expected_tokens: float = 128.0,
                         method: str = "planner") -> DecoupledPlan:
        """Decide (point, bits, codec) for token-level streaming: the
        one-shot objective plus ``expected_tokens`` times the per-token
        steady-state term. ``method`` mirrors :meth:`decide`."""
        bw = bandwidth if bandwidth is not None else \
            self.cfg.bandwidth_bytes_per_s
        terms = self.stream_terms
        if method == "planner":
            return terms.decide(bw, expected_tokens)
        sol = solve(terms.ilp_problem(bw, expected_tokens), method)
        if sol is None:
            return terms.cloud_only_plan(bw, expected_tokens)
        return terms.plan_from_solution(sol)

    def for_edge(self, edge_profile) -> "JaladEngine":
        """A per-device engine sharing this engine's tables, cloud profile
        and PlanSpace precomputation; only the edge-time vector differs.
        The fleet server builds one of these per heterogeneous device."""
        lat = LatencyModel(self.latency.fmacs_per_point, edge_profile,
                           self.latency.cloud, self.latency.input_bytes)
        return dataclasses.replace(
            self, latency=lat,
            _plan_space=self.plan_space.with_edge(edge_profile),
            _stream_terms=None, _tri_space=None)

    def make_runner(self, params, plan: DecoupledPlan) -> DecoupledRunner:
        return DecoupledRunner(self.model, params, plan)

    def make_tri_runner(self, params,
                        plan: DecoupledPlan) -> TriDecoupledRunner:
        return TriDecoupledRunner(self.model, params, plan)
