"""The paper's experiments for the port's harness (``repro_torch.bench``).

One module per experiment, each the twin of the same name under the JAX
package's ``benchmarks/``: the same experiments over the same registered
devices, giving the same records. Their tensors live on the run's torch
device (``Context.torch_device``); on the card the accelerator records
launch the port's CUDA kernels.
"""
