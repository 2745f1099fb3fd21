"""Deep-structure decoupling: split a model at point i*, quantize the
boundary to c bits through a boundary codec, and run head (edge) / tail
(cloud) as separate steps — plus the engine that glues predictor tables,
latency model and planner into the paper's decision procedure.

The three-tier and token-streaming parts of the reference are not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, List, Optional, Tuple

import torch

if TYPE_CHECKING:
    from repro_torch.codec import BoundaryCodec, WireBlob

from repro_torch.config.types import JaladConfig
from repro_torch.core.ilp import ILPProblem, solve
from repro_torch.core.latency import LatencyModel
from repro_torch.core.planner import PlanSpace
from repro_torch.core.predictor import PredictorTables
from repro_torch.device import tensor_device
from repro_torch.models.api import Model, batch_to
from repro_torch.models.init import torch_dtype


@dataclass
class DecoupledPlan:
    """One decision: where to cut, at what bit width, through which codec
    (``point < 0``: no cut, everything on the cloud)."""

    point: int
    bits: int
    predicted_latency: float
    predicted_acc_drop: float
    solve_ms: float
    codec: str = "huffman"

    @property
    def is_cloud_only(self) -> bool:
        return self.point < 0


@dataclass
class DecoupledRunner:
    """Executable split model on the parameters' device. ``edge_step``
    runs the head and encodes the boundary (a host ``WireBlob`` — the
    link); ``cloud_step`` decodes it and finishes the inference. The wire
    format is entirely the plan's codec's."""

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

    def run(self, batch):
        """Full decoupled inference; returns (logits, transfer_bytes)."""
        blob, extras = self.edge_step(batch)
        return self.cloud_step(blob, extras), blob.nbytes


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

    @property
    def plan_space(self) -> PlanSpace:
        if self._plan_space is None:
            self._plan_space = PlanSpace.build(
                self.tables, self.latency, self.cfg.accuracy_drop_budget,
                self.point_indices,
            )
        return self._plan_space

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

    def make_runner(self, params, plan: DecoupledPlan) -> DecoupledRunner:
        return DecoupledRunner(self.model, params, plan)
