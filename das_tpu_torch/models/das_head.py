"""Distribution-aware single-stage pose head, port of
``das_tpu/models/das_head.py``: the eval and train forwards and the loss.

An FCOS-style anchor-free multi-level head predicting, per location, cls
score (1), centerness (1), root xy-offset (2), root depth (1), per-joint
uvd (3J) and per-joint sigma (3J), with per-level learnable ``Scale``s, a
shared recursive-update refinement branch, and the RealNVP flows of the
RLE loss.

Output layout per level (NHWC): cls (N,H,W,1), pose_pred (N,H,W,3+6J),
centerness (N,H,W,1), ref_uvd (N,H,W,3J); pose_pred channels are
[dx, dy, depth, uvd..., sigma...]. The root joint's dz is pinned to 0 and
its sigma to 1; at eval the refined uvd replaces the raw one, depth is
divided by ``depth_factor``, uv are scaled by the level stride and z by
``z_norm``; in training pose_pred carries the raw uvd and the loss reads
the refined one. The strides are the config's (8..64) although the feature
maps are at 4..32: the reference's convention, kept.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..config.registry import HEADS
from ..losses import (binary_cross_entropy, rle_loss, sigmoid_focal_loss,
                      smooth_l1_loss)
from ..parallel.mesh import sum_over
from .layers import ConvModule, DeformConv2d, Scale, conv2d, he_normal_, \
    normal_
from .real_nvp import RealNVP
from .recursive_update import RecursiveUpdateBranch


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@HEADS.register_module()
class DASHead(nn.Module):
    """DAS head. ``fused_gn`` with a bias-free head (``conv_bias='auto'``)
    runs each eval 3x3 conv+GN+relu module as one fused kernel call.
    ``dcn_train_gather_mode`` picks the DCN lowering under training. The
    regress ranges, center sampling and loss configs are the train step's
    (``parallel/train_step.py``). ``remat`` makes each tower and branch
    ``ConvModule`` its own rematerialised region under training, and is the
    RU's default, as in the JAX head (das_head.py:123-126, :166)."""

    def __init__(self, num_classes: int = 1, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 2,
                 strides: Sequence[int] = (8, 16, 32, 64),
                 regress_ranges: Sequence[Tuple[float, float]] = (),
                 num_joints: int = 15, root_idx: int = 2,
                 depth_factor: float = 1.0, z_norm: float = 1.0,
                 center_sample_radius: float = 1.5,
                 centerness_on_reg: bool = True,
                 centerness_branch: Sequence[int] = (64,),
                 centerness_alpha: float = 2.5,
                 cls_branch: Sequence[int] = (256,),
                 reg_branch: Sequence[Sequence[int]] = (
                     (256,), (256,), (256,), (256,)),
                 dcn_on_last_conv: bool = True,
                 dcn_gather_mode: str = 'patch',
                 dcn_train_gather_mode: str = 'auto',
                 dcn_shift_radius: int = 2, dcn_shift_budget: int = 2048,
                 fused_gn: bool = False, conv_bias=True,
                 norm_cfg: Optional[dict] = None,
                 recursive_update: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 loss_cls=None, loss_reg=None, loss_pose=None,
                 loss_centerness=None, background_label=None,
                 remat: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.num_joints = num_joints
        self.root_idx = root_idx
        self.depth_factor = depth_factor
        self.z_norm = z_norm
        self.strides = list(strides)
        self.centerness_on_reg = centerness_on_reg
        self.bg_label = num_classes if background_label is None \
            else background_label
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        J = num_joints
        group_reg_dims = (2, 1, J * 3, J * 3)
        norm_cfg = norm_cfg or dict(type='GN', num_groups=32)
        kw = dict(norm_cfg=norm_cfg, bias=conv_bias,
                  dcn_gather_mode=dcn_gather_mode,
                  dcn_train_gather_mode=dcn_train_gather_mode,
                  dcn_shift_radius=dcn_shift_radius,
                  dcn_shift_budget=dcn_shift_budget, fused_gn=fused_gn,
                  remat=remat)

        def tower():
            return nn.ModuleList([
                ConvModule(in_channels if i == 0 else feat_channels,
                           feat_channels, 3, 1, 1,
                           dcn=dcn_on_last_conv and i == stacked_convs - 1,
                           **kw)
                for i in range(stacked_convs)])

        def branch(channels):
            mods, cin = [], feat_channels
            for c in channels:
                mods.append(ConvModule(cin, c, 3, 1, 1, **kw))
                cin = c
            return nn.ModuleList(mods)

        def last(channels):
            return list(channels)[-1] if len(channels) else feat_channels

        self.cls_convs = tower()
        self.reg_convs = tower()
        self.pose_convs = tower()
        self.conv_cls_prev = branch(cls_branch)
        self.conv_cls = nn.Conv2d(last(cls_branch), num_classes, 1)
        self.conv_reg_prevs = nn.ModuleList(
            [branch(reg_branch[i]) for i in range(2)])
        self.conv_regs = nn.ModuleList(
            [nn.Conv2d(last(reg_branch[i]), group_reg_dims[i], 1)
             for i in range(2)])
        self.conv_pose_prevs = nn.ModuleList(
            [branch(reg_branch[i]) for i in range(2, 4)])
        self.conv_poses = nn.ModuleList(
            [nn.Conv2d(last(reg_branch[i]), group_reg_dims[i], 1)
             for i in range(2, 4)])
        self.conv_centerness_prev = branch(centerness_branch)
        self.conv_centerness = nn.Conv2d(last(centerness_branch), 1, 1)
        self.scales = nn.ModuleList([
            nn.ModuleList([Scale(1.0) for _ in range(4)])
            for _ in self.strides])

        ru = dict(recursive_update or {})
        ru.setdefault('num_joints', num_joints)
        ru.setdefault('remat', remat)
        ru.setdefault('dcn_gather_mode', dcn_gather_mode)
        ru.setdefault('dcn_train_gather_mode', dcn_train_gather_mode)
        ru.setdefault('dcn_shift_radius', dcn_shift_radius)
        ru.setdefault('dcn_shift_budget', dcn_shift_budget)
        self.recursive_update_branch = RecursiveUpdateBranch(**ru)
        # read from the RU config itself, as JAX das_head.py:173 does
        self.prev_loss = bool(ru.get('prev_loss', False))

        self.flow3d = RealNVP(dim=3)
        self.flow2d = RealNVP(dim=2)
        self.flow3d_update = RealNVP(dim=3)
        self.flow2d_update = RealNVP(dim=2)

    def init_weights(self, gen: torch.Generator):
        """The reference head init (anchor_free_mono3d_pose_head.py:92-98,
        das_head.py:86-92): Normal(0.01) on every tower, branch and
        prediction conv, the focal prior on the cls bias, zero conv_offset;
        the RU's DCN weight He-normal and its sampling_offset Normal(0.01).
        Call after a default init of the whole model."""
        ru = self.recursive_update_branch
        for name, m in self.named_modules():
            if name.startswith('recursive_update_branch'):
                continue
            if isinstance(m, (nn.Conv2d, DeformConv2d)):
                normal_(m.weight, 0.01, gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        for m in ru.modules():
            if isinstance(m, DeformConv2d):
                he_normal_(m.weight, gen)
            elif hasattr(m, 'sampling_offset'):
                normal_(m.sampling_offset.weight, 0.01, gen)
        for m in self.modules():
            if isinstance(m, DeformConv2d):
                nn.init.zeros_(m.conv_offset.weight)
                nn.init.zeros_(m.conv_offset.bias)
        nn.init.constant_(self.conv_cls.bias,
                          -math.log((1 - 0.01) / 0.01))

    @staticmethod
    def _run(mods, x):
        for m in mods:
            x = m(x)
        return x

    def forward_single(self, x: torch.Tensor, lvl: int,
                       select_idx: Optional[torch.Tensor] = None):
        """One level. x (N,C,H,W); returns NHWC cls, pose_pred, centerness,
        ref_uvd, all f32. ``select_idx`` (N, K) restricts the RU
        re-sampling to those flat points (training: the assigned positives
        from ``DAS.loss``)."""
        J = self.num_joints
        stride = self.strides[lvl]

        cls_feat = self._run(self.cls_convs, x)
        cls_score = _nhwc(conv2d(self.conv_cls,
                                 self._run(self.conv_cls_prev, cls_feat)))
        reg_feat = self._run(self.reg_convs, x)
        pose_feat = self._run(self.pose_convs, x)

        preds = []
        for i in range(4):
            feat = reg_feat if i < 2 else pose_feat
            prevs = self.conv_reg_prevs[i] if i < 2 \
                else self.conv_pose_prevs[i - 2]
            head = self.conv_regs[i] if i < 2 else self.conv_poses[i - 2]
            preds.append(_nhwc(conv2d(head, self._run(prevs, feat))))

        ctr_in = reg_feat if self.centerness_on_reg else cls_feat
        centerness = _nhwc(conv2d(
            self.conv_centerness,
            self._run(self.conv_centerness_prev, ctr_in)))

        s_off, s_depth, s_uv, s_d = self.scales[lvl]
        offset = s_off(preds[0])
        depth = s_depth(preds[1])
        uvd = preds[2].float().reshape(*preds[2].shape[:3], J, 3)
        uvd = torch.cat([s_uv(uvd[..., :2]), s_d(uvd[..., 2:])], dim=-1)
        sigma = preds[3].float().reshape(*preds[3].shape[:3], J, 3).clone()

        # relative root depth pinned to 0 / sigma 1 (ref das_head.py:249-250)
        uvd[..., self.root_idx, 2] = 0.0
        sigma[..., self.root_idx, 2] = 1.0
        sigma = sigma.reshape(*sigma.shape[:3], J * 3)
        uvd_flat = uvd.reshape(*uvd.shape[:3], J * 3)

        # Sparse eval refinement (test_cfg.sparse_refine): the decode keeps
        # at most nms_pre candidates per level, ranked by score*centerness,
        # which this branch does not change; so the re-sampling runs only
        # at those points, selected with the decode's own key and k. Never
        # under training, where DAS.loss passes the positives or None.
        N, Hf, Wf = cls_score.shape[:3]
        nms_pre = int(self.test_cfg.get('nms_pre', 1000))
        ru = self.recursive_update_branch
        if ru.num_layers == 0:
            select_idx = None
        elif select_idx is None and not self.training \
                and bool(self.test_cfg.get('sparse_refine', False)) \
                and Hf * Wf > nms_pre:
            ranked = torch.sigmoid(cls_score.float()) \
                * torch.sigmoid(centerness.float())
            select_idx = torch.topk(ranked.reshape(N, Hf * Wf), nms_pre,
                                    dim=1).indices

        dt = pose_feat.dtype
        ref_out = ru(pose_feat, uvd_flat.to(dt), select_idx)
        if select_idx is not None:
            base, refined = ref_out
            nidx = torch.arange(N, device=x.device)[:, None]
            ref_uvd = base.float().reshape(N, Hf * Wf, J * 3).clone()
            ref_uvd[nidx, select_idx] = refined.float()
            ref_uvd = ref_uvd.reshape(N, Hf, Wf, J * 3)
        else:
            ref_uvd = ref_out.float()
        ref_uvd = ref_uvd.reshape(*ref_uvd.shape[:3], J, 3).clone()
        ref_uvd[..., self.root_idx, 2] = 0.0

        if self.training:
            pose_pred = torch.cat([offset, depth, uvd_flat, sigma], dim=-1)
        else:
            # eval path: fold the refined uvd in and rescale (ref :256-262)
            out_uvd = ref_uvd * torch.tensor(
                [stride, stride, self.z_norm], dtype=torch.float32,
                device=x.device)
            depth = depth / self.depth_factor
            pose_pred = torch.cat(
                [offset, depth, out_uvd.reshape(*out_uvd.shape[:3], J * 3),
                 sigma], dim=-1)
        ref_flat = ref_uvd.reshape(*ref_uvd.shape[:3], J * 3)
        return cls_score.float(), pose_pred, centerness.float(), ref_flat

    def forward(self, feats: Sequence[torch.Tensor], select_idx=None):
        outs = [self.forward_single(
                    f, i, None if select_idx is None else select_idx[i])
                for i, f in enumerate(feats)]
        cls_scores, pose_preds, centernesses, ref_uvds = zip(*outs)
        return list(cls_scores), list(pose_preds), list(centernesses), \
            list(ref_uvds)

    def loss(self, cls_scores, pose_preds, centernesses, aux_pose_preds,
             targets: Dict[str, torch.Tensor], max_pos: int = 1024,
             group=None) -> Dict[str, torch.Tensor]:
        """Training loss (JAX das_head.py:296-432, ref das_head.py:283-486),
        fixed-shape, in f32.

        ``targets`` comes from ``core.targets.get_targets``: flat per-point
        labels, pose targets, centerness targets and strides over all levels
        and images. The positives are gathered into a fixed ``max_pos`` set,
        first by flat index (a stable sort, as ``jax.lax.top_k`` orders
        ties); ``pos_overflow`` counts those the budget drops.

        With a process group this rank's batch is a shard of the global
        one: every normaliser (the positive and image counts, the 3D
        positives, the selected positives, the visible joints) is summed
        over the ranks in one all-reduce, so each term is this rank's share
        and the ranks' terms add up to the global batch's loss. ``max_pos``
        is then the global budget, taken by each rank from its own points.
        """
        J = self.num_joints
        num_imgs = cls_scores[0].shape[0]
        flat_cls = torch.cat([c.reshape(-1, self.num_classes)
                              for c in cls_scores])
        flat_pose = torch.cat([p.reshape(-1, 3 + 6 * J) for p in pose_preds])
        flat_ctr = torch.cat([c.reshape(-1) for c in centernesses])
        flat_aux = torch.cat([a.reshape(-1, 3 * J) for a in aux_pose_preds])

        labels = targets['labels']
        pose_t = targets['pose_targets']
        ctr_t = targets['centerness_targets']
        strides_t = targets['strides']

        pos_mask = labels < self.bg_label
        num_pos = pos_mask.sum()

        # a fixed-size positive set: positives first, by flat index
        k = min(max_pos, labels.shape[0])
        pos_idx = positives_first(pos_mask, k)
        sel = pos_mask[pos_idx]
        selF = sel.float()
        p_pose = flat_pose[pos_idx]
        p_aux = flat_aux[pos_idx].reshape(k, J, 3)
        p_ctr = flat_ctr[pos_idx]
        p_t = pose_t[pos_idx]
        p_ctr_t = ctr_t[pos_idx]
        p_strides = strides_t[pos_idx]

        cw = self.train_cfg.get('code_weight')
        cw_depth = float(cw[2]) if cw else 1.0
        cw_pose = float(cw[3]) if cw else 1.0

        gt_uvd_full = p_t[:, 3:3 + 3 * J]
        is_2d = (gt_uvd_full[:, 2::3] == 0).all(dim=1)
        is_3d = ~is_2d & sel
        depth_w = is_3d.float()
        gt_w = (p_t[:, 3 + 3 * J:].reshape(k, J, 1)
                * selF[:, None, None]).expand(k, J, 3)
        gt_w_all = gt_w.repeat(1, 2, 1) if self.prev_loss else gt_w

        # the normalisers: over the global batch with a group
        num_pos_all, num_imgs_all, num_3d, num_sel, vis_count = sum_over(
            group, num_pos, torch.tensor(num_imgs, device=labels.device),
            depth_w.sum(), selF.sum(), gt_w_all[..., 0].sum())
        loss_cls = sigmoid_focal_loss(flat_cls, labels,
                                      avg_factor=num_pos_all + num_imgs_all)

        # depth loss, 3D positives only (ref :366-381)
        loss_depth = smooth_l1_loss(
            p_pose[:, 2], p_t[:, 2] * self.depth_factor,
            weight=depth_w * cw_depth, avg_factor=num_3d.clamp_min(1.0))
        loss_depth = torch.where(num_3d > 0, loss_depth,
                                 torch.zeros_like(loss_depth))

        # RLE pose loss; 2D samples carry no depth (ref :387-390) and their
        # RAW sigma-z is pinned to 1 before the sigmoid (ref :390, :409)
        uvd = p_pose[:, 3:3 + 3 * J].reshape(k, J, 3)
        sigma = p_pose[:, 3 + 3 * J:].reshape(k, J, 3)
        flat2d = is_2d[:, None, None]

        def set_z(t, value):
            return torch.where(flat2d, torch.cat(
                [t[..., :2], torch.full_like(t[..., 2:], value)], -1), t)

        uvd = set_z(uvd, 0.0)
        uvd_update = set_z(p_aux, 0.0)
        sigma = torch.sigmoid(set_z(sigma, 1.0)) + 1e-9

        # root-to-joint -> point-to-joint targets (ref :392-406)
        diff = p_t[:, :3] * p_strides[:, None]
        diff = torch.cat([diff[:, :2], torch.zeros_like(diff[:, 2:])], -1)
        real_gt = gt_uvd_full.reshape(k, J, 3) - diff[:, None, :]
        real_gt = torch.cat(
            [real_gt[..., :2] * (1.0 / p_strides)[:, None, None],
             real_gt[..., 2:] * (1.0 / self.z_norm)], -1)

        def flow_logphi(bar_mu, f3d, f2d):
            lp3 = f3d(bar_mu.reshape(-1, 3)).reshape(k, J)
            lp2 = f2d(bar_mu[..., :2].reshape(-1, 2)).reshape(k, J)
            return torch.where(is_2d[:, None], lp2, lp3)

        if self.prev_loss:
            lp_upd = flow_logphi((uvd_update - real_gt) / sigma,
                                 self.flow3d_update, self.flow2d_update)
            lp_raw = flow_logphi((uvd - real_gt) / sigma, self.flow3d,
                                 self.flow2d)
            uvd_all = torch.cat([uvd_update, uvd], dim=1)
            real_gt_all = real_gt.repeat(1, 2, 1)
            sigma_all = sigma.repeat(1, 2, 1)
            log_phi = torch.cat([lp_upd, lp_raw], dim=1)[..., None]
        else:
            log_phi = flow_logphi((uvd_update - real_gt) / sigma,
                                  self.flow3d, self.flow2d)[..., None]
            uvd_all, real_gt_all, sigma_all = uvd_update, real_gt, sigma
        nf_loss = torch.log(sigma_all) - log_phi
        loss_pose = rle_loss(nf_loss, uvd_all, sigma_all, real_gt_all,
                             gt_w_all, weight=cw_pose, vis_count=vis_count)

        # centerness (ref :470)
        loss_ctr = binary_cross_entropy(p_ctr, p_ctr_t, weight=selF,
                                        avg_factor=num_sel.clamp_min(1e-12))

        has_pos = (num_pos_all > 0).float()
        return dict(loss_cls=loss_cls,
                    loss_depth=loss_depth * has_pos,
                    loss_pose=loss_pose * has_pos,
                    loss_centerness=loss_ctr * has_pos,
                    # positives dropped by this rank's max_pos gather
                    pos_overflow=(num_pos - k).clamp_min(0).float())


def positives_first(pos: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` entries along the last axis of the 0/1
    mask ``pos`` when positives come first, each group by index: what
    ``jax.lax.top_k`` returns on 0/1 scores. ``torch.topk`` promises no
    order among ties, so this is a stable sort."""
    return torch.sort(pos.to(torch.uint8), dim=-1, descending=True,
                      stable=True).indices[..., :k]
