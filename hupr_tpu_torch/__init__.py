"""hupr_tpu_torch: the raw-ADC -> keypoints serving path of hupr_tpu in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

  engine.pipeline   make_e2e_infer: raw ADC frames -> keypoints
  models            HuPRNet (MNet, Encoder3D, MSCSA decoder, PRGCN) with the
                    reference's state_dict keys; convert.state_dict_from_jax
  ops               radar DSP (torch.fft), normalize, resize, argmax decode,
                    the MSCSA attention and its CUDA kernel (csrc/)
  config            the YAML schema of hupr_tpu.config

The package imports torch only: no JAX and nothing of hupr_tpu.
"""

__version__ = "0.1.0"
