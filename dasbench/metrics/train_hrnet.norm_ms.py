"""train_hrnet.norm_ms: the device time a training step spends in
batch-norm kernels, ms a step, from the profiler's trace by kernel name:
the kernels the program's ``models.layers.BatchNorm`` launches in a
bf16 step on the H100, read from this cell's trace (PyTorch 2.11, cuDNN
on channels-last float32):

- ``cudnn::batchnorm_fwtr_nhwc_semiPersist``: train-mode forward (each
  training BatchNorm, and again in remat's recompute);
- ``cudnn::batchnorm_bwtr_nhwc_semiPersist``: its backward;
- ``at::native::reduce_kernel<...WelfordOps...>``: ``torch.var_mean`` of
  the running statistics' update (no other op of the step reduces with
  Welford's algorithm);
- ``cudnn::bn_fw_inf_1C11_kernel_NHWC``: the frozen stem's and stage 1's
  eval-mode forward;
- ``batch_norm_elementwise_backward_eval``,
  ``batch_norm_backward_reduce_channels_last_kernel`` and
  ``batch_norm_calc_invstd``: that eval-mode forward's backward.

The casts to and from float32 around each norm are PyTorch's copy
kernels, which every layer launches; they are not counted."""

from dasbench.trace import kernel_s

NAMES = ('batchnorm_fwtr', 'batchnorm_bwtr', 'WelfordOps', 'bn_fw_inf',
         'batch_norm')


def read(record):
    if record['kind'] != 'train':
        return None
    tr = record['trace']
    return 1e3 * kernel_s(tr, NAMES) / tr['units']
