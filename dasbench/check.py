"""The comparison that decides ``correct``.

Serving, for each request the window sampled:

- ``pre_gap``: the program's preprocessed batch against the reference's
  preprocessing of the same frames (float64): the largest difference, in
  normalised pixel units.
- ``head_gap``: the head's dense outputs at every level (cls, centerness,
  root offset, depth, joint uvd, sigma) against the reference's forward
  of its own preprocessed batch with the same weights: the worst
  relative L2 gap, ||program - reference|| / ||reference||, over levels
  and fields. Where the re-sampling of the RU field is sparse, the
  reference's field takes its re-sampled values at the points of its own
  selection (the ``nms_pre`` best by its own cls and centerness) and its
  gated values elsewhere; the points where the program's selection
  differs from it are left out here and counted by ``select_gap``.
- ``select_gap``: the program's sparse selection (the points it passed
  to the RU, read by a hook on its input) against the reference's own:
  the share of the reference's points the program did not select, the
  worst over levels and images (1 where one side selects and the other
  re-samples the whole level).
- ``decode_gap_px``: the people the program decoded against the
  reference decode of the program's own dense outputs (the decode's
  top-k and NMS are discontinuous, so they are judged on their own
  input, which ``head_gap`` and ``select_gap`` hold to the reference):
  people matched one to one within 1 px, the largest coordinate
  difference of a matched pair (px; depth units for z), and 1 where a
  person on either side is left unmatched.

Training, over the first three steps, which set-up drove through the
window's own step (a configuration's ``limits`` name the numbers that
decide; the others are printed):

- ``bn_gap``: the running statistics of the training BatchNorms after
  step 1 (a forward quantity: 0.9 of the start and 0.1 of the batch's
  moments), each statistic's move against the reference's, relative L2,
  the median over the first quarter of them in the model's order, where
  rounding is not yet amplified through depth (``bn_gap_all``: over all).
- ``change_gap_median``: the parameters' change over the three steps,
  each leaf's gap between the program's norm and the reference's over
  the larger of the reference's norm of that leaf and of the median
  leaf; the median leaf's (``change_gap``: the worst leaf's;
  ``head_change_gap_median``: the median over the head's leaves, whose
  gradient the samplers' backward carries).
- ``sampler_bwd_gap``: the call of the program's bilinear sampler
  backward (K4's kernel) in step 1 with the most points times channels
  an image among those whose incoming gradient is not all zero (the
  'clip' DCN's on the largest level), against the reference's gradient of plain bilinear sampling
  (autograd in float64) from the same arguments, which are the program's
  own state there: relative L2 of each gradient the call returned, the
  worst (1 where step 1 ran no sampler backward).
- ``loss_gap``, ``loss1_gap``: each step's (step 1's) loss terms against
  the reference's, relative to the term or to a hundredth of the step's
  sum of terms; ``grad_gap`` (worst leaf), ``grad_gap_median``,
  ``grad_norm_gap``: the gradient the optimizer took at step 1 (its
  momentum less the weight decay, over the clip's scale).

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the leaf numbers.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from . import weights
from .reference import decode as ref_decode
from .reference import model as ref_model
from .reference import precision
from .reference import preprocess as ref_pre
from .reference import train as ref_train


def reference_model(cfg: Dict, seed: int, device) -> ref_model.DAS:
    model = ref_model.build(cfg['model'], device)
    model.load_state_dict(weights.make_state(
        cfg['model'], cfg['assumed']['weights'], seed, device), strict=True)
    return model


def _rel(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.double(), r.double()
    return float(torch.linalg.vector_norm(p - r)
                 / torch.linalg.vector_norm(r).clamp_min(1e-30))


def selection_masks(sel_idx, head) -> List[Optional[torch.Tensor]]:
    """The program's sparse selection a level as an (N, H*W) bool mask, or
    None where it re-sampled the whole level, from the (N, K) indices it
    passed to the RU (``sel_idx``, one entry a level)."""
    out = []
    for idx, cls in zip(sel_idx, head[0]):
        if idx is None:
            out.append(None)
            continue
        N, H, W, _ = cls.shape
        m = torch.zeros(N, H * W, dtype=torch.bool, device=idx.device)
        m.scatter_(1, idx.long(), True)
        out.append(m.to(cls.device))
    return out


def select_gap(sel_prog: List, ref_levels: List[Dict], mcfg: Dict) -> float:
    """The share of the reference's own selected points that the program's
    selection (``selection_masks``) missed, the worst over levels and
    images; 1 where only one side selects."""
    k, worst = int(mcfg['test_cfg']['nms_pre']), 0.0
    for prog, ref in zip(sel_prog, ref_levels):
        mine = ref_model.sparse_select(ref['cls'], ref['ctr'], k)
        if prog is None or mine is None:
            worst = max(worst, float((prog is None) != (mine is None)))
            continue
        hit = (prog & mine).sum(1).double() / mine.sum(1).double()
        worst = max(worst, float(1.0 - hit.min()))
    return worst


def head_gap(head, ref_levels: List[Dict], mcfg: Dict,
             sel_prog: Optional[List] = None) -> float:
    """The worst relative L2 gap of the program's dense outputs ``head``
    (cls, pose, centerness lists, NHWC) against the reference's eval
    fields, the uvd field re-sampled at the reference's own selection;
    points where the program's selection ``sel_prog`` (masks a level)
    differs are left out of the uvd gap."""
    cls_l, pose_l, ctr_l = head
    J, worst = mcfg['num_joints'], 0.0
    k = int(mcfg['test_cfg']['nms_pre'])
    sel_prog = sel_prog or [None] * len(cls_l)
    for cls, pose, ctr, ref, prog in zip(cls_l, pose_l, ctr_l, ref_levels,
                                         sel_prog):
        N, H, W, _ = cls.shape
        sel = ref_model.sparse_select(ref['cls'], ref['ctr'], k) \
            if mcfg['test_cfg'].get('sparse_refine') else None
        uvd_ref = ref['refined'] if sel is None else torch.where(
            sel.reshape(N, H, W, 1), ref['refined'], ref['gated'])
        pose = pose.float()
        uvd = pose[..., 3:3 + 3 * J]
        if sel is not None and prog is not None:
            same = (sel == prog).reshape(N, H, W, 1)
            uvd, uvd_ref = uvd * same, uvd_ref * same
        pairs = ((cls, ref['cls']), (ctr, ref['ctr']),
                 (pose[..., 0:2], ref['offset']),
                 (pose[..., 2:3], ref['depth']),
                 (uvd, uvd_ref), (pose[..., 3 + 3 * J:], ref['sigma']))
        gaps = [_rel(p, r) for p, r in pairs]
        print(f'[dasbench] level {tuple(cls.shape[1:3])} gaps (cls, ctr, '
              f'offset, depth, uvd, sigma): {gaps}', file=sys.stderr)
        worst = max([worst] + gaps)
    return worst


def match_people(prog: np.ndarray, ref: np.ndarray):
    """(unmatched count, largest matched gap) of two people sets
    (K, J, 3): pairs matched greedily by their largest coordinate
    difference, up to 1."""
    if len(prog) == 0 or len(ref) == 0:
        return len(prog) + len(ref), 0.0
    d = np.abs(prog[:, None].astype(np.float64)
               - ref[None].astype(np.float64)).reshape(
        len(prog), len(ref), -1).max(-1)
    used_p, used_r, worst, matched = set(), set(), 0.0, 0
    for flat in np.argsort(d, axis=None):
        i, j = divmod(int(flat), d.shape[1])
        if d[i, j] >= 1.0:
            break
        if i in used_p or j in used_r:
            continue
        used_p.add(i)
        used_r.add(j)
        matched += 1
        worst = max(worst, float(d[i, j]))
    return len(prog) + len(ref) - 2 * matched, worst


def serve_numbers(cfg: Dict, seed: int, samples: List[Dict],
                  pool: np.ndarray, sf: torch.Tensor, device) -> Dict:
    """The serving numbers, the worst over ``samples``."""
    mcfg = cfg['model']
    nums = dict(pre_gap=0.0, head_gap=0.0, select_gap=0.0,
                decode_gap_px=0.0, unmatched=0)
    with precision.use(precision.EXACT), torch.no_grad():
        model = reference_model(cfg, seed, device).eval()
        for s in samples:
            frames = torch.from_numpy(pool[s['frames']]).to(device)
            x = ref_pre.preprocess(frames, cfg['test_scale'])
            nums['pre_gap'] = max(nums['pre_gap'], float(
                (s['x'].double() - x).abs().max()))
            levels = ref_model.eval_outputs(model(x.float()), mcfg)
            sel = selection_masks(s['sel'], s['head'])
            nums['head_gap'] = max(nums['head_gap'],
                                   head_gap(s['head'], levels, mcfg, sel))
            nums['select_gap'] = max(nums['select_gap'],
                                     select_gap(sel, levels, mcfg))
            del levels
            cls_l, pose_l, ctr_l = s['head']
            people = ref_decode.decode(
                [dict(cls=c, ctr=t, pose=p)
                 for c, p, t in zip(cls_l, pose_l, ctr_l)],
                mcfg['strides'], sf, mcfg['num_joints'], mcfg['test_cfg'])
            for res, ref in zip(s['results'], people):
                n, gap = match_people(np.asarray(res['poses']),
                                      ref['poses'].cpu().numpy())
                nums['unmatched'] += n
                nums['decode_gap_px'] = max(nums['decode_gap_px'], gap,
                                            1.0 if n else 0.0)
    return nums


def control_samples(cfg: Dict, seed: int, rows: List[np.ndarray],
                    pool: np.ndarray, sf: torch.Tensor, device,
                    p: precision.Precision = precision.CONTROL) -> List[Dict]:
    """The reference put in the program's place at precision ``p``: for
    each request (frame indices ``rows``) what the program's serving path
    gives, in its format."""
    mcfg, out = cfg['model'], []
    k = int(mcfg['test_cfg']['nms_pre'])
    J = mcfg['num_joints']
    with precision.use(p), torch.no_grad():
        model = reference_model(cfg, seed, device).eval()
        for idx in rows:
            frames = torch.from_numpy(pool[idx]).to(device)
            x = ref_pre.preprocess(frames, cfg['test_scale']).float()
            levels = ref_model.eval_outputs(model(x), mcfg)
            head, sels = ([], [], []), []
            for f in levels:
                N, H, W, _ = f['cls'].shape
                sel = ref_model.sparse_select(f['cls'], f['ctr'], k)
                uvd = f['refined'] if sel is None else torch.where(
                    sel.reshape(N, H, W, 1), f['refined'], f['gated'])
                sels.append(None if sel is None else
                            sel.nonzero()[:, 1].reshape(N, k))
                head[0].append(f['cls'])
                head[1].append(torch.cat([f['offset'], f['depth'], uvd,
                                          f['sigma']], -1))
                head[2].append(f['ctr'])
            people = ref_decode.decode(
                [dict(cls=c, ctr=t, pose=q) for c, q, t in zip(*head)],
                mcfg['strides'], sf, J, mcfg['test_cfg'])
            out.append(dict(frames=idx, x=x, head=head, sel=sels, results=[
                dict(poses=r['poses'].float().cpu().numpy()) for r in people]))
    return out


def serve(cfg: Dict, seed: int, samples: List[Dict], pool: np.ndarray,
          sf: torch.Tensor, device) -> List:
    """[(name, value, limit)] of a serving run."""
    if not samples:
        return [('sampled_requests', 0, 1)]
    nums = serve_numbers(cfg, seed, samples, pool, sf, device)
    lim = cfg['limits']['serve']
    return [(k, nums[k], lim[k]) for k in lim]


# ---------------------------------------------------------------- training

def reference_steps(cfg: Dict, seed: int, batches: List[Dict], device,
                    p: precision.Precision = precision.EXACT,
                    half: bool = False) -> Dict:
    """The reference's first steps from ``seed``'s weights on ``batches``
    at precision ``p`` (with ``half``, on the first half of each batch):
    each step's loss terms, the momentum after step 1 and the parameters
    after the last, on the host."""
    mcfg = cfg['model']
    B = batches[0]['img'].shape[0]
    max_pos = int(cfg['optimizer']['max_pos_per_image']) * B
    with precision.use(p):
        model = reference_model(cfg, seed, device)
        tr = ref_train.Trainer(model, mcfg, cfg['optimizer'], max_pos)
        losses, m1 = [], None
        for b in batches:
            if half:
                b = {k: v[:B // 2] for k, v in b.items()}
            losses.append(tr.step(b))
            if m1 is None:
                m1 = {k: v.detach().to('cpu', copy=True)
                      for k, v in tr.momentum.items()}
                grad_norm = tr.grad_norm
                bn1 = running_after_step(model)
        p3 = {k: v.detach().to('cpu', copy=True)
              for k, v in model.named_parameters()}
        decay = {k: cfg['optimizer']['weight_decay'] * tr.wd[k]
                 for k in p3}
    return dict(losses=losses, m1=m1, p3=p3, decay=decay, bn1=bn1,
                grad_norm=grad_norm, clip=cfg['optimizer']['grad_clip'])


def running_after_step(model) -> Dict:
    """The running statistics of the reference's training BatchNorms after
    one step from their initial values: 0.9 of those and 0.1 of the batch's
    moments (biased variance), on the host."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, ref_model.BatchNorm) and m.training:
            mean, var = m.moments
            out[f'{name}.running_mean'] = (0.9 * m.running_mean + 0.1 * mean
                                           ).to('cpu', copy=True)
            out[f'{name}.running_var'] = (0.9 * m.running_var + 0.1 * var
                                          ).to('cpu', copy=True)
    return out


def bn_gaps(prog: Dict, ref: Dict, start: Dict) -> List[float]:
    """Each running statistic's move over the first step, the program's
    against the reference's (relative L2), in the model's order."""
    return [_rel(prog[k] - start[k], ref[k] - start[k]) for k in ref]


def leaf_gaps(prog: Dict, ref: Dict, keys: List[str]) -> List:
    """[(gap, leaf)] from the worst: the gap of the leaf's norms over the
    larger of the reference's norm of it and of the median leaf."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = statistics.median(norms.values())
    return sorted(((abs(float(torch.linalg.vector_norm(prog[k].double()))
                        - norms[k]) / max(norms[k], med, 1e-30), k)
                   for k in keys), reverse=True)


def train_numbers(prog: Dict, ref: Dict, p0: Dict) -> Dict:
    """loss_gap, grad_gap, change_gap of ``prog``'s first steps against
    ``ref``'s, both from the parameters ``p0`` (host tensors)."""
    step_gaps = []
    for lp, lr in zip(prog['losses'], ref['losses']):
        floor = 0.01 * sum(abs(v) for v in lr.values())
        step_gaps.append(max(abs(lp[k] - v) / max(abs(v), floor)
                             for k, v in lr.items()))

    start = p0
    p0 = {k: v for k, v in p0.items() if k in ref['p3']}

    def grad(r):
        # the step-1 gradient before the global-norm clip: the momentum
        # less the weight decay, over the clip's scale
        scale = min(1.0, ref['clip'] / (r['grad_norm'] + 1e-6))
        return {k: (r['m1'][k] - ref['decay'][k] * p0[k]) / scale
                for k in p0}
    g_ref, g_prog = grad(ref), grad(prog)
    gnorm = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in g_ref.items()}
    med = statistics.median(gnorm.values())
    keys = [k for k in p0 if gnorm[k] >= 1e-3 * med]
    change_ref = {k: ref['p3'][k] - p0[k] for k in keys}
    change_prog = {k: prog['p3'][k] - p0[k] for k in keys}
    grad = leaf_gaps(g_prog, g_ref, keys)
    change = leaf_gaps(change_prog, change_ref, keys)
    bn = bn_gaps(prog['bn1'], ref['bn1'], start)
    return dict(loss_gap=max(step_gaps), loss1_gap=step_gaps[0],
                grad_gap=grad[0][0], change_gap=change[0][0],
                grad_gap_median=statistics.median(g for g, _ in grad),
                change_gap_median=statistics.median(g for g, _ in change),
                head_change_gap_median=statistics.median(
                    g for g, k in change if k.startswith('bbox_head.')),
                grad_norm_gap=abs(prog['grad_norm'] - ref['grad_norm'])
                / ref['grad_norm'],
                bn_gap=statistics.median(bn[:max(1, len(bn) // 4)]),
                bn_gap_all=statistics.median(bn),
                left_out=len(p0) - len(keys), worst_grad=grad[:4],
                worst_change=change[:4])


def _sampler_grads(rec: Dict, flat, grad, n: int, device):
    """The reference's (d flat, dx, dy) of image ``n`` of the recorded
    call, from ``flat`` and ``grad`` (float64)."""
    with torch.enable_grad():
        f = flat[n:n + 1].to(device, torch.float64).requires_grad_()
        x = rec['x'][n:n + 1].to(device, torch.float64).requires_grad_()
        y = rec['y'][n:n + 1].to(device, torch.float64).requires_grad_()
        out = ref_model.bilinear(f, x, y, rec['H'], rec['W'])
        return torch.autograd.grad(
            out, (f, x, y), grad[n:n + 1].to(device, torch.float64))


def sampler_backward_gap(rec: Optional[Dict], device,
                         control: bool = False) -> float:
    """``sampler_bwd_gap`` of the recorded call ``rec``; with ``control``,
    of the reference itself with the image and the incoming gradient
    rounded to fp8 e4m3 (one scale a tensor) in the program's place."""
    if rec is None:
        return 1.0
    flat, grad = rec['flat'], rec['grad']
    if control:
        flat = precision.round_e4m3(flat.float())
        grad = precision.round_e4m3(grad.float())
    num, den = [0.0] * 3, [0.0] * 3
    for n in range(rec['flat'].shape[0]):
        ref = _sampler_grads(rec, rec['flat'], rec['grad'], n, device)
        got = _sampler_grads(rec, flat, grad, n, device) if control else \
            [None if t is None else t[n:n + 1] for t in rec['out']]
        for i, want in enumerate(rec['needs']):
            if want:
                d = got[i].to(device, torch.float64) - ref[i]
                num[i] += float((d * d).sum())
                den[i] += float((ref[i] * ref[i]).sum())
        del ref, got
    return max(math.sqrt(a / max(b, 1e-300)) for a, b, w in
               zip(num, den, rec['needs']) if w)


def initial_params(cfg: Dict, seed: int, device) -> Dict:
    """The state both sides start from, on the host: the parameters, and
    the running statistics under their names."""
    return {k: v.cpu() for k, v in weights.make_state(
        cfg['model'], cfg['assumed']['weights'], seed, device).items()}


def train(cfg: Dict, seed: int, prog: Dict, batches: List[Dict],
          device) -> List:
    """[(name, value, limit)] of a training run."""
    ref = reference_steps(cfg, seed, batches, device)
    nums = train_numbers(prog, ref, initial_params(cfg, seed, device))
    nums['sampler_bwd_gap'] = sampler_backward_gap(prog['sampler'], device)
    print(f"[dasbench] reference losses {ref['losses']}, grad norm "
          f"{ref['grad_norm']!r} (program {prog['grad_norm']!r}); leaves "
          f"left out {nums['left_out']}; worst gradient leaves "
          f"{nums['worst_grad']}; worst change leaves "
          f"{nums['worst_change']}", file=sys.stderr, flush=True)
    lim = cfg['limits']['train']
    return [(k, nums[k], lim[k]) for k in lim]
