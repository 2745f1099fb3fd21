"""System ``fleet``: a CNN served across the JALAD cut to a fleet of edge
devices against one shared cloud (``repro_torch.serving.fleet``).

Set-up draws the weights and a pool of input requests on the device
from the seed, and builds the server with ``build_fleet_server``, which
calibrates the planner's tables at the request batch. A call serves one
wave through ``FleetServer.serve`` and copies every answer to the host."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bench.counts import codec as codec_counts
from bench.reference import quant
from bench.systems import family
from bench.weights import draw, same_layout

PlanKey = Tuple[int, int, str]
CLOUD_ONLY: PlanKey = (-1, 0, "cloud")


class System:
    def __init__(self, cfg: dict, seed: int, device: str):
        from repro_torch.config import JaladConfig, get_config
        from repro_torch.config.types import DeviceProfile
        from repro_torch.models.api import build_model
        from repro_torch.serving.fleet import build_fleet_server

        self.cfg, self.m, s = cfg, cfg["model"], cfg["serving"]
        self.ref = ref = family(cfg)
        self.frames = cfg["frames"]
        port = get_config(cfg["arch"]).replace(**ref.port_overrides(self.m))
        params = draw(ref.layout(self.m), seed, device, torch.float32,
                      gain=cfg["init"]["gain"])
        if not same_layout(params, build_model(port).abstract_params()):
            raise RuntimeError("the reference's layout is not the program's")
        profiles = [DeviceProfile(p["name"], float(p["flops"]), float(p["w"]))
                    for p in s["edge_profiles"] for _ in range(p["count"])]
        jc = JaladConfig(bits_choices=tuple(s["bits"]),
                         codec_choices=tuple(s["codecs"]))
        self.fleet, self.params = build_fleet_server(
            port, jc, profiles, device=device, seed=seed % (1 << 31),
            params=params, calib_batches=s["calib_batches"],
            calib_batch_size=self.frames, cloud_batch=s["cloud_batch"])
        gen = torch.Generator(device=device)
        gen.manual_seed((seed + 1) & ((1 << 63) - 1))
        hw = self.m["image_size"]
        self.pool = torch.randn((s["input_pool"], self.frames, 3, hw, hw),
                                generator=gen, device=device)
        self.offset = int(np.random.default_rng(seed).integers(
            s["input_pool"]))
        self.image_flops = ref.flops_per_image(self.m)
        self.answers: Dict[int, Tuple[np.ndarray, PlanKey]] = {}

    def _input(self, uid: int) -> torch.Tensor:
        return self.pool[(uid + self.offset) % self.pool.shape[0]]

    def _codec_bytes(self, plan: PlanKey) -> int:
        point, bits, codec = plan
        if point < 0:
            return 0
        shape = self.ref.boundary_shape(self.m, point, self.frames)
        return (codec_counts.encode_bytes(codec, shape, bits)
                + codec_counts.decode_bytes(codec, shape, bits))

    def serve(self, uids, devices, bandwidths) -> dict:
        from repro_torch.serving.fleet import FleetRequest

        reqs = [FleetRequest(uid=int(u), device_id=int(d),
                             batch={"images": self._input(int(u))},
                             bandwidth=float(b))
                for u, d, b in zip(uids, devices, bandwidths)]
        n_groups = len(self.fleet.cloud_groups)
        done = self.fleet.serve(reqs)
        # numpy on the host: arrays the garbage collector does not walk.
        host = (torch.stack([r.logits for r in done]).cpu().numpy() if done
                else [])
        plans = []
        for r, logits in zip(done, host):
            plan = (CLOUD_ONLY if r.plan.is_cloud_only
                    else (r.plan.point, r.plan.bits, r.plan.codec))
            self.answers[r.uid] = (logits, plan)
            plans.append(plan)
        return {"requests": len(done), "answered": [r.uid for r in done],
                "flops": self.image_flops * self.frames * len(done),
                "codec_bytes": sum(self._codec_bytes(p) for p in plans),
                "group_sizes": [len(g.uids) for g in
                                self.fleet.cloud_groups[n_groups:]
                                if g.key is not None]}

    def close(self) -> None:
        """Free the program's state; the weights and inputs stay for the
        reference."""
        self.fleet = None

    def reference_logits(self, uid: int, plan: PlanKey,
                         precision: str = "f32") -> torch.Tensor:
        x, ref = self._input(uid), self.ref
        point, bits, codec = plan
        if point < 0:
            return ref.forward(self.m, self.params, x, precision=precision)
        b = ref.forward(self.m, self.params, x, 0, point + 1, precision)
        b = quant.codec_qdq(b, bits, codec)
        return ref.forward(self.m, self.params, b, point + 1, None,
                           precision)

    def reference_range(self, uid: int, plan: PlanKey, edge: float):
        """The plain reference's logits of a served request, and the lowest
        and highest that a sound float32 program may serve. Where the cut
        is the last layer, the served logits are the wire's own values, and
        a code within ``edge`` of a rounding edge may fall on either side
        (``quant.codec_qdq_bounds``); after a tail, the logits alone."""
        point, bits, codec = plan
        if 0 <= point == len(self.ref.layers(self.m)) - 1:
            b = self.ref.forward(self.m, self.params, self._input(uid), 0,
                                 point + 1)
            lo, hi = quant.codec_qdq_bounds(b, bits, codec, edge)
            return quant.codec_qdq(b, bits, codec), lo, hi
        want = self.reference_logits(uid, plan)
        return want, want, want

    def check(self, rng: np.random.Generator, n: int, uids=None,
              control: bool = False, code_edge: float = 0.0
              ) -> Dict[str, float]:
        """The widest gap between a served request's logits and the range
        the plain reference allows them (``reference_range``), as a share
        of the reference's largest logit, over a sample of ``n`` answered
        requests drawn with ``rng``. With ``control`` the reference in TF32
        stands in the program's place."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        pool = sorted(u for u in (self.answers if uids is None else uids)
                      if u >= 0)
        sample = rng.choice(pool, size=min(n, len(pool)), replace=False)
        worst = 0.0
        for uid in sample:
            served, plan = self.answers[int(uid)]
            want, lo, hi = self.reference_range(int(uid), plan, code_edge)
            got = (self.reference_logits(int(uid), plan, "tf32") if control
                   else torch.from_numpy(served).to(want.device))
            gap = torch.maximum(lo - got, got - hi).clamp_min(0)
            worst = max(worst, float(gap.max() / want.abs().max()))
        return {"logits_rel_err": worst}
