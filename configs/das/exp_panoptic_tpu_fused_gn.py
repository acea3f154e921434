# exp_panoptic_tpu with a bias-free head and the fused conv+GN+relu kernel.
#
# This is the configuration in which the JAX model runs
# das_tpu/ops/pallas_convgn.py::conv_gn_relu: with conv_bias='auto' (mmcv's
# rule: a conv followed by a norm has no bias) every GN ConvModule of the
# head is bias-free, so with fused_gn=True the eval 3x3 conv+GN+relu modules
# (9 per level) pass the fused gate (das_tpu/models/layers.py
# _use_fused_gn). The DCN convs lose their bias too and stay unfused.
#
# It has no released checkpoint: the reference's head convs carry biases
# (configs/_base_/models/das.py sets conv_bias=True), so a reference .pth
# does not load into this head. Train it, or serve it on seeded weights.
_base_ = ['./exp_panoptic_tpu.py']

model = dict(bbox_head=dict(conv_bias='auto', fused_gn=True))
