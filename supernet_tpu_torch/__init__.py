"""PyTorch/CUDA port of ``supernet_tpu``, for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module names
and its public layouts (NHWC activations, HWIO ``w_mu`` [k,k,Cin,Cout], raw
pre-softplus ``w_sigma`` [Cout]) so each module can be checked against its
counterpart. It imports ``torch``, never ``jax``, and nothing of the JAX
package (it keeps its own copies of the configs and the tiling). Its Pallas
TPU kernels become hand-written CUDA kernels (``csrc/``, bound in
``ops/kernels``): a CUDA tensor always goes through the kernel, and the
plain PyTorch version of each kernel serves CPU tensors and the
comparisons.

Ported so far: the 2-D serving path (``serving.InferenceSession``) and the
2-D training step (``train.make_train_step`` and its multi-step,
accumulation and eval twins). Entry points run on the card unless the
caller names another device.
"""
