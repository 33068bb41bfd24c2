"""hupr_tpu_torch: hupr_tpu in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

  main              the CLI: python -m hupr_tpu_torch.main --config X --dir Y
                    [--eval]; train, evaluate, checkpoint, resume
  engine.runner     Runner: the train and eval loop, sequence-mode eval
                    (engine.seq_eval) or classic, .pth checkpoints
                    (engine.checkpoint), the OKS evaluator (eval)
  engine.pipeline   make_e2e_infer: raw ADC frames -> keypoints
  engine.export     that program as a torch.export artifact, the attention
                    and convolution kernels kept as custom ops
                    (export_serving, load_serving)
  engine.steps      make_train_step / make_eval_step: one batch of raw
                    windows and joints -> losses, an optimizer step
  data              the HuPR dataset, its batch loader and GT JSON; the
                    native frame loader (native/npy_loader.cc); live
                    DCA1000 capture (data.capture, native/dca1000.cc)
  preprocessing     the preprocessing CLI: raw captures -> .npy cubes
  scripts           live_serve (capture -> streaming poses), parity_audit
                    (model_best.pth -> COCO AP), the microbenchmark, the
                    remat and batch-size scripts, dp_scaling (the
                    data-parallel step over several cards), export_serving,
                    profile_train and conv_microbench
  models            HuPRNet (MNet, Encoder3D, MSCSA decoder, PRGCN) with the
                    reference's state_dict keys; convert.state_dict_from_jax
  ops               radar DSP (torch.fft), normalize, resize, Gaussian
                    targets, BCE, argmax decode, the MSCSA attention and
                    its forward and backward CUDA kernels, the Encoder3Ds'
                    float32 3x3x3 convolution forward and its kernel
                    (csrc/)
  parallel          data parallel and multi-process runs over
                    torch.distributed (HUPR_MULTIHOST=1, one process per
                    card): batch blocks, synced BN, rank-file eval
  config            the YAML schema of hupr_tpu.config, the CLI's flags

The package imports torch and numpy only: no JAX, nothing of hupr_tpu, and
none of PyYAML (but to read a YAML), tqdm, cv2, PIL or matplotlib (but
to draw).
"""

__version__ = "0.1.0"
