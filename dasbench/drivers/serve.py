"""Serving driver: batches of camera frames sent through the program's
serving path at the mix's fixed rate (an open loop: a request is sent
when it is due, or when the one before is answered where that is
later).

A request is B uint8 BGR frames taken from a pool in pageable host
memory (made from the seed), copied to the card, preprocessed there
(``ops.preprocess.make_preprocess_fn`` to the configuration's test
bucket), run through ``apis.inference.make_predict_fn`` (the bf16 model
and its decode) and brought back by ``results_to_host`` as the people of
each frame. Its latency is the host clock from when it was due (the
frames in host memory) to the result dicts on the host.

A mix with ``saturate`` offers a rate above what the path sustains: the
requests go back to back, none is sent once the window's clock has run
out, and its measure is the images completed over the window.

The window keeps, by reservoir sampling from the seed, a few requests'
frames, preprocessed batch, the head's dense outputs (a forward hook on
the head), the points the head passed to the RU (a hook on its input)
and results; after the window they are compared with the plain
reference (``dasbench.check``). A traced run also records stream spans
around preprocessing, the backbone, the neck, the head and the decode
(hooks on the program's modules) and profiles a few steady requests.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import check, weights
from ..reference import preprocess as ref_pre


def make_frames(n: int, hw, seed: int, device) -> np.ndarray:
    """``n`` uint8 BGR frames (n, H, W, 3) in pageable host memory: a
    smooth random scene upsampled from a coarse grid plus pixel noise,
    made on the device from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2654435761 + 1) % 2 ** 63)
    H, W = hw
    coarse = torch.rand(n, 3, H // 16, W // 16, generator=gen,
                        device=device) * 255
    img = torch.nn.functional.interpolate(coarse, size=(H, W),
                                          mode='bilinear', align_corners=False)
    img = img + torch.randn(n, 3, H, W, generator=gen, device=device) * 12
    img = img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return img.contiguous().cpu().numpy()


def offset_report(model, run_once) -> str:
    """The DCN offsets of one request: |offset| quantiles (pixels) and the
    share of fractional ones, over every ``conv_offset`` of the model."""
    from das_tpu_torch.models.layers import DeformConv2d
    seen = []
    hooks = [m.conv_offset.register_forward_hook(
        lambda mod, inp, out: seen.append(out[:, :18].detach().float()
                                          .abs().reshape(-1)))
        for m in model.modules() if isinstance(m, DeformConv2d)]
    try:
        run_once()
    finally:
        for h in hooks:
            h.remove()
    v = torch.cat(seen)
    sub = v[torch.randperm(v.numel(), device=v.device)[:1 << 20]]
    q = torch.quantile(sub, torch.tensor([0.5, 0.9, 0.99], device=v.device))
    frac = float(((v - v.round()).abs() > 0.05).float().mean())
    return (f'DCN offsets over {len(seen)} calls: |offset| median '
            f'{float(q[0]):.3f} px, p90 {float(q[1]):.3f}, p99 '
            f'{float(q[2]):.3f}, max {float(v.max()):.3f}; fractional '
            f'(>0.05 px from an integer) {frac:.4f}')


class Cell:
    """The program's serving path for one configuration and mix."""

    def __init__(self, ctx):
        from das_tpu_torch.apis.inference import (init_model,
                                                  make_predict_fn,
                                                  results_to_host)
        from das_tpu_torch.config import Config
        from das_tpu_torch.ops.preprocess import make_preprocess_fn

        self.ctx, self.cfg, p = ctx, ctx.config, ctx.traffic['params']
        self.p = p
        self.B = B = int(p['batch'])
        H, W = self.frame_hw = tuple(p['frame_hw'])
        (nh, nw), self.hw = ref_pre.bucket(H, W, self.cfg['test_scale'])
        dev = ctx.device
        cfg = Config.fromfile(str(ctx.root / self.cfg['repo_config']))
        self.model, cfg = init_model(
            cfg, dtype=getattr(torch, self.cfg['compute_dtype']), device=dev)
        head = cfg.model.bbox_head
        self.predict = make_predict_fn(
            self.model, dict(cfg.model.test_cfg), int(head.num_joints),
            tuple(head.strides), device=dev)
        self.to_host = results_to_host
        norm = self.cfg['model']['img_norm']
        self.pre = make_preprocess_fn((H, W), (nh, nw), self.hw,
                                      norm['mean'], norm['std'],
                                      norm['to_rgb'])
        self.sf = torch.tensor([[nw / W, nh / H]] * B, dtype=torch.float32,
                               device=dev)
        self.paths = [f'frame{i}' for i in range(B)]
        self.captured = {}
        head = self.model.bbox_head
        head.register_forward_hook(self._capture)
        head.recursive_update_branch.register_forward_pre_hook(
            self._capture_selection)
        self.spans = ctx.spans()

    def _capture(self, mod, inp, out):
        if self.captured.get('want'):
            self.captured['head'] = out[:3]

    def _capture_selection(self, mod, args):
        # the RU's third argument: the (N, K) points it re-samples at this
        # level, or None for all of them
        if self.captured.get('want'):
            idx = args[2] if len(args) > 2 else None
            self.captured['sel'].append(
                None if idx is None else idx.detach().clone())

    def load(self, seed: int):
        """Weights and frames for ``seed``."""
        ctx = self.ctx
        self.model.load_state_dict(weights.make_state(
            self.cfg['model'], self.cfg['assumed']['weights'], seed,
            ctx.device), strict=True)
        self.pool = make_frames(int(self.p['pool']), self.frame_hw, seed,
                                ctx.device)
        rng = np.random.default_rng(np.random.SeedSequence(int(seed)))
        self.order = rng.integers(0, len(self.pool), size=(1 << 16, self.B))
        self.pick = np.random.default_rng(
            np.random.SeedSequence([int(seed), 1]))

    def request(self, k: int, keep: bool = False):
        """Request ``k`` of the seed's sequence; with ``keep`` also what
        the check compares."""
        sp = self.spans
        self.captured = dict(want=keep, sel=[])
        idx = self.order[k % len(self.order)]
        frames = np.stack([self.pool[i] for i in idx])
        raw = torch.from_numpy(frames).to(self.ctx.device)
        sp.mark('pre0')
        x = self.pre(raw)
        sp.mark('pre1')
        decoded = self.predict(x, self.sf)
        sp.mark('decode1')
        t = time.perf_counter()
        res = self.to_host(decoded, self.paths)
        sp.add_ms('to_host', (time.perf_counter() - t) * 1e3)
        sp.close('pre0', 'pre1', 'preprocess')
        sp.close('head1', 'decode1', 'decode')
        if not keep:
            return res, None
        return res, dict(frames=idx.copy(), x=x, head=self.captured['head'],
                         sel=self.captured['sel'], results=res)

    def window(self, seconds: float, opened=None, rate: float = None):
        """The requests due in ``seconds``, one every 1/``rate`` s (the
        mix's rate unless given): a request is sent when it is due, or as
        soon as the one before it is answered where that is later; with
        ``saturate`` none is sent once ``seconds`` have passed. A request's
        latency runs from when it was due to its answer on the host, its
        service time from when it was sent. Returns a dict: ``lat`` and
        ``svc`` (ms a request), ``secs`` (to the last answer), ``bad``
        (non-finite results), ``kept`` (samples), ``late`` (the largest
        wait from due to sent, ms)."""
        rate = rate or float(self.p['rate'])
        saturate = bool(self.p.get('saturate', False))
        want = int(self.p['sample'])
        kept: List = []
        lat, svc, bad, k, late = [], [], 0, 0, 0.0
        t0 = opened() if opened else time.perf_counter()
        while k / rate < seconds:
            due = t0 + k / rate
            now = time.perf_counter()
            if saturate and now - t0 >= seconds:
                break
            if due > now:
                time.sleep(due - now)
            sent = time.perf_counter()
            late = max(late, sent - due)
            slot = k if k < want else int(self.pick.integers(0, k + 1))
            res, sample = self.request(k, slot < want)
            done = time.perf_counter()
            lat.append((done - due) * 1e3)
            svc.append((done - sent) * 1e3)
            bad += sum(not np.isfinite(r['poses']).all() for r in res)
            if sample is not None:
                if k < want:
                    kept.append(sample)
                else:
                    kept[slot] = sample
            k += 1
        return dict(lat=lat, svc=svc, secs=time.perf_counter() - t0, bad=bad,
                    kept=kept, late=late * 1e3)

    def free(self):
        self.spans.unhook()
        del self.model, self.predict


def run(ctx) -> Dict:
    from das_tpu_torch.ops import gather, oks_nms

    cell = Cell(ctx)
    cell.load(ctx.seed)
    p, cfg, B = cell.p, cell.cfg, cell.B
    for i in range(int(p['warmup'])):
        cell.request(-1 - i)
    ctx.log(offset_report(cell.model, lambda: cell.request(-1)))
    ctx.sync()
    cell.spans.reset()
    if ctx.trace:
        for name in ('backbone', 'neck'):
            cell.spans.hook(getattr(cell.model, name), name)
        cell.spans.hook(cell.model.bbox_head, 'head')

    def counts():
        return (gather.sampler_launches, gather.launches, oks_nms.launches)
    before = counts()
    w = cell.window(ctx.seconds, ctx.open_window)
    ctx.close_window()
    lat, secs, kept = w['lat'], w['secs'], w['kept']
    k = len(lat)
    per = [(a - b) / k for a, b in zip(counts(), before)]
    expect = [float(cfg['launches']['serve'][n])
              for n in ('sampler', 'gather', 'oks_nms')]
    ctx.log(f'window: {k} requests in {secs:.4f} s ({B * k / secs:.4f} '
            f'images/s), latency p50 {np.percentile(lat, 50):.4f} ms, p95 '
            f'{np.percentile(lat, 95):.4f} ms, service p50 '
            f'{np.percentile(w["svc"], 50):.4f} ms, largest wait from due '
            f'to sent {w["late"]:.4f} ms; launches a request: sampler, gather, '
            f'oks_nms {per} (expected {expect})')
    out = dict(
        e2e=dict(serve_p95_ms=float(np.percentile(lat, 95)),
                 serve_img_s=B * k / secs, setup_s=ctx.setup_s),
        samples=dict(serve_p95_ms=k, serve_img_s=k),
        attempted=k, failed=int(w['bad']),
        memory_peak_bytes=ctx.memory_peak())
    if ctx.trace:
        spans = cell.spans.read_ms()
        cell.spans.unhook()
        heads = []

        def traced(i):
            heads.append(cell.request(k + i, True)[1]['head'])
        tr = ctx.profile(traced, int(p['profile_requests']))
        out.update(trace=tr, record=dict(
            kind='serve', config=cfg, batch=B, hw=cell.hw, trace=tr,
            spans=spans, window=dict(units=k, seconds=secs),
            service_ms=float(np.median(w['svc'])),
            launches_ok=per == expect, heads=heads, sf=cell.sf))
    frames, sf = cell.pool, cell.sf
    cell.free()
    out['checks'] = check.serve(ctx.config, ctx.seed, kept, frames, sf,
                                ctx.device)
    return out
