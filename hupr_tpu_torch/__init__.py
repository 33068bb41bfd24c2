"""hupr_tpu_torch: the serving path and the training step of hupr_tpu in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

  engine.pipeline   make_e2e_infer: raw ADC frames -> keypoints
  engine.steps      make_train_step / make_eval_step: one batch of raw
                    windows and joints -> losses, an optimizer step
  models            HuPRNet (MNet, Encoder3D, MSCSA decoder, PRGCN) with the
                    reference's state_dict keys; convert.state_dict_from_jax
  ops               radar DSP (torch.fft), normalize, resize, Gaussian
                    targets, BCE, argmax decode, the MSCSA attention and
                    its forward and backward CUDA kernels (csrc/)
  config            the YAML schema of hupr_tpu.config

The package imports torch only: no JAX and nothing of hupr_tpu.
"""

__version__ = "0.1.0"
