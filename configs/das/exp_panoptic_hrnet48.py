# DAS on CMU Panoptic with an HRNetV2-W48 backbone: exp_panoptic's FPN, DAS
# head, recursive update, buckets, optimizer and schedule, with mmdet's
# HRNet (configs/hrnet/*hrnetv2p_w48*; Sun et al., CVPR 2019,
# arXiv:1902.09212; Wang et al., TPAMI 2020, arXiv:1908.07919) in place of
# MSPN2. Its four branches (48, 96, 192, 384 channels at strides 4 to 32)
# feed the FPN. No pretrained checkpoint is named: the ImageNet
# HRNetV2-W48 weights are not in the repository.
_base_ = ['./exp_panoptic.py']

model = dict(
    pretrained=None,
    backbone=dict(
        _delete_=True,
        type='HRNet',
        extra=dict(
            stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                        num_blocks=[4], num_channels=[64]),
            stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                        num_blocks=[4, 4], num_channels=[48, 96]),
            stage3=dict(num_modules=4, num_branches=3, block='BASIC',
                        num_blocks=[4, 4, 4], num_channels=[48, 96, 192]),
            stage4=dict(num_modules=3, num_branches=4, block='BASIC',
                        num_blocks=[4, 4, 4, 4],
                        num_channels=[48, 96, 192, 384])),
        norm_cfg=dict(type='SyncBN'),
        # the stem and stage 1 held still, as the DAS recipe holds MSPN's
        # stem and first unit
        frozen_stages=1,
        norm_eval=False,
        # no rematerialised regions: at B=4 640x1344 the step peaks at
        # 17.5 GiB without them and runs 11-32% faster on the H100 than
        # with the stem and stage 1, and each HRModule, as regions
        remat=False,
    ),
    neck=dict(in_channels=[48, 96, 192, 384]),
)
