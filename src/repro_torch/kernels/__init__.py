"""Hand-written Hopper kernels of the port, each beside its plain version."""

#: the kernel modules, one CUDA source each (``csrc/<name>.cu``); each
#: counts its wrapper's launches in ``launches``
KERNELS = ("flash_attention", "pchase", "memcpy", "dbuf_copy", "strided",
           "rmsnorm", "batch_cache", "paged_decode")
