"""System ``stream``: a decoder's token streams across the JALAD cut
(``repro_torch.serving.streaming.TokenStreamSession``), on a plan pinned
by the configuration.

Set-up draws the weights on the device from the seed, builds the engine
with ``build_edge_cloud_server`` (its calibration, as a server starts),
and opens one session from ``JaladEngine.make_runner(...)
.stream_session(ServeConfig(...))``. A call is one engine step."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench.systems import family
from bench.weights import draw, same_layout


class System:
    def __init__(self, cfg: dict, seed: int, device: str):
        from repro_torch.config import JaladConfig, ServeConfig, get_config
        from repro_torch.core.decoupler import DecoupledPlan
        from repro_torch.models.api import build_model
        from repro_torch.serving.edge_cloud import build_edge_cloud_server

        self.cfg, self.m, s = cfg, cfg["model"], cfg["serving"]
        self.s = s
        self.ref = ref = family(cfg)
        port = get_config(cfg["arch"]).replace(**ref.port_overrides(self.m))
        model = build_model(port)
        params = draw(ref.layout(self.m), seed, device, torch.bfloat16,
                      gain=cfg["init"]["gain"],
                      embed_std=cfg["init"]["embed_std"])
        if not same_layout(params, model.abstract_params()):
            raise RuntimeError("the reference's layout is not the program's")
        server, self.params = build_edge_cloud_server(
            port, JaladConfig(codec_choices=(s["codec"],)), params=params,
            seed=seed % (1 << 31), calib_batches=1, calib_batch_size=2,
            seq_len=s["calib_seq"])
        self.point = model.decoupling_points().index(s["cut"])
        plan = DecoupledPlan(self.point, s["bits"], 0.0, 0.0, 0.0, s["codec"])
        runner = server.engine.make_runner(self.params, plan)
        self.session = runner.stream_session(
            ServeConfig(max_batch=s["slots"], max_seq_len=s["cache_len"]),
            cloud_kv_bits=s["cloud_kv_bits"])
        self.vocab = self.m["vocab_size"]
        self.decode_flops = ref.decode_flops(self.m, s["cache_len"])
        self.requests: List = []
        self._uid = 0

    def submit(self, tokens: np.ndarray, n_out: int):
        from repro_torch.serving.scheduler import GenRequest

        req = GenRequest(uid=self._uid, tokens=tokens, max_new_tokens=n_out)
        self._uid += 1
        self.requests.append(req)
        self.session.submit(req)
        return req

    def pending(self) -> bool:
        return bool(self.session.queue)

    def inflight(self) -> List:
        return [r for r in self.requests if r.done_step < 0]

    def step(self) -> dict:
        sess = self.session
        n_events, n_tok = len(sess.events), sess.tokens_out
        sess.step()
        joined = [uid for kind, _, uid in sess.events[n_events:]
                  if kind == "join"]
        decoded = sess.tokens_out - n_tok - len(joined)
        prompts = [len(self.requests[uid].tokens) for uid in joined]
        return {"joins": len(joined), "prefill_tokens": sum(prompts),
                "decode_tokens": decoded,
                "flops": (sum(self.ref.prefill_flops(self.m, p)
                              for p in prompts)
                          + decoded * self.decode_flops)}

    def close(self) -> None:
        self.session = None

    def _sequence(self, req) -> torch.Tensor:
        toks = np.concatenate([req.tokens, np.asarray(req.out_tokens[:-1],
                                                      np.int64)])
        return torch.as_tensor(toks, dtype=torch.int64,
                               device=self.params["embed"].device)

    def gaps(self, req, control: bool = False) -> torch.Tensor:
        """For each served token of ``req``: how far the plain reference's
        logit of it lies below the reference's best, in standard
        deviations of the reference's logits at that position. With
        ``control`` the token is the one the reference in fp8 puts first."""
        seq = self._sequence(req)
        p = len(req.tokens)
        kw = dict(point=self.point, prompt=p, bits=self.s["bits"],
                  int8_kv=self.s["cloud_kv_bits"] == 8)
        lg = self.ref.forward(self.m, self.params, seq, **kw)[p - 1:]
        if control:
            toks = self.ref.forward(self.m, self.params, seq, precision="fp8",
                               **kw)[p - 1:].argmax(-1)
        else:
            toks = torch.as_tensor(req.out_tokens, device=lg.device)
        best = lg.max(-1).values
        return (best - lg.gather(1, toks[:, None])[:, 0]) / lg.std(-1)

    def check(self, rng: np.random.Generator, n: int, done=None,
              control: bool = False) -> Dict[str, float]:
        """The widest gap (see ``gaps``) over a sample of ``n`` finished
        requests drawn with ``rng``, the longest among them."""
        done = [r for r in (self.requests if done is None else done)
                if r.done_step >= 0]
        if not done:
            return {"token_gap_sd": float("inf")}
        longest = max(done, key=lambda r: len(r.tokens) + len(r.out_tokens))
        rest = [r for r in done if r is not longest]
        pick = [longest] + [rest[i] for i in rng.choice(
            len(rest), size=min(n - 1, len(rest)), replace=False)]
        worst = max(float(self.gaps(r, control).max()) for r in pick)
        return {"token_gap_sd": worst}
