"""Row passes of a boosting round (``boost``) and the histograms for given
node ids (``hist``), re-exported as ``rabit_tpu.ops`` does."""

from rabit_tpu_torch.ops.hist import (  # noqa: F401 (re-exports)
    node_histograms,
    node_histograms_kernel,
    node_histograms_onehot,
    node_histograms_scatter,
    segment_sum,
    segment_sum_matmul,
)

#: rabit_tpu's name for the histogram kernel (its Pallas kernel; here the
#: CUDA one, csrc/hist.cu nodes mode)
node_histograms_pallas = node_histograms_kernel
