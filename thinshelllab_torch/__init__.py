"""ThinShellLab in PyTorch: the port of `thinshelllab_tpu` to PyTorch and CUDA.

Module paths and function names mirror the JAX package, so each function
here has a counterpart of the same name there. Scenes are built on the host
in numpy (`core.builder`), moved to a device once (`SceneSpec.to`), and
stepped by plain functions on tensors (`engine.stepper.simulate`), and
differentiated by the implicit-function-theorem adjoint
(`engine.adjoint.backward`). The two DIA kernels are CUDA C++
(`csrc/dia_spmv.cu`): the SpMV serves every operator apply of the forward
CG and of the adjoint GMRES, the smoothing sweeps precondition the forward
CG. Their plain PyTorch versions sit beside their wrappers in
`ops.dia_spmv`.

The JAX package runs its small batched contractions at
`Precision.HIGHEST`; the port keeps float32 products in full float32 by
turning TF32 off for matmuls and cuDNN.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
