# DAS on CMU Panoptic with a Swin-L backbone at window 12: exp_panoptic's
# FPN, DAS head, recursive update, buckets, optimizer and schedule, with
# mmdet's SwinTransformer (Liu et al., ICCV 2021, arXiv:2103.14030) in place
# of MSPN2, at the settings of mmdet's Mask2Former Swin-L config
# (configs/mask2former/mask2former_swin-l-p4-w12-384-in21k_lsj_16x1_100e_
# coco-panoptic.py; the ImageNet-22K 384x384 checkpoint
# swin_large_patch4_window12_384_22k). Its four stages (192, 384, 768, 1536
# channels at strides 4 to 32) feed the FPN. No pretrained checkpoint is
# named: the Swin-L weights are not in the repository.
_base_ = ['./exp_panoptic.py']

model = dict(
    pretrained=None,
    backbone=dict(
        _delete_=True,
        type='SwinTransformer',
        pretrain_img_size=384,
        embed_dims=192,
        depths=[2, 2, 18, 2],
        num_heads=[6, 12, 24, 48],
        window_size=12,
        mlp_ratio=4,
        qkv_bias=True,
        patch_size=4,
        patch_norm=True,
        drop_path_rate=0.3,
        out_indices=(0, 1, 2, 3),
        # the patch embedding, stage 0 and its output norm held still, as
        # the DAS recipe holds MSPN's stem and first unit
        frozen_stages=1,
    ),
    neck=dict(in_channels=[192, 384, 768, 1536]),
)
