"""serve.k3_roofline: the decode's OKS-NMS kernels' share of their
roofline, %: the least time of the keep masks of the profiled requests
(``dasbench.roofline.k3_oks_nms``, joint terms counted from each
request's own candidates, in the decode's score order) over the device
time of ``oks_mask_kernel`` and ``oks_scan_kernel``."""

import torch

from dasbench.reference import decode as ref_decode
from dasbench.roofline.k3_oks_nms import joint_terms, nms_bound_ms
from dasbench.trace import kernel_s


def read(record):
    tr = record['trace']
    t = kernel_s(tr, ('oks_mask_kernel', 'oks_scan_kernel'))
    if not record['launches_ok'] or t <= 0:
        return None
    m = record['config']['model']
    tc, J = m['test_cfg'], m['num_joints']
    bound = 0.0
    for cls_l, pose_l, ctr_l in record['heads']:
        c = ref_decode.candidates(
            [dict(cls=a, ctr=b, pose=p) for a, p, b in
             zip(cls_l, pose_l, ctr_l)], m['strides'],
            record['sf'], J,
            int(tc['nms_pre']))
        s = torch.where(c['scores'] > tc['score_thr'], c['scores'],
                        torch.full_like(c['scores'], -float('inf')))
        order = torch.sort(s, dim=1, descending=True, stable=True).indices
        xy = c['poses'][..., :2].gather(
            1, order[..., None, None].expand(-1, -1, J, 2)).float()
        area = (xy[..., 0].amax(-1) - xy[..., 0].amin(-1)) * \
            (xy[..., 1].amax(-1) - xy[..., 1].amin(-1))
        B, M = s.shape
        terms = joint_terms(xy, area, float(tc['nms_thr']),
                            2.0 * (2 * 0.08) ** 2)
        bound += nms_bound_ms(B, M, J, terms) / 1e3
    return 100.0 * bound / t
