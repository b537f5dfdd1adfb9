"""PyTorch/CUDA port of everyvoice_tpu's text-to-wav serving path.

FastSpeech2 + HiFiGAN (resblock 1) synthesis from the JAX package's EVTP
checkpoints, with each HiFiGAN MRF stage run by a hand-written sm_90a CUDA
kernel (``ops/csrc/mrf.cu``). The package imports torch, numpy and the
standard library only: nothing of JAX, flax or ``everyvoice_tpu``.
"""
