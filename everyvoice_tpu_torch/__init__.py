"""PyTorch/CUDA port of everyvoice_tpu: FastSpeech2 + HiFiGAN (resblock 1)
synthesis from the JAX package's EVTP checkpoints, preprocessing of a corpus
into the artifacts training reads, and FastSpeech2 training on them. Each
HiFiGAN MRF stage runs on a hand-written sm_90a CUDA kernel
(``ops/csrc/mrf.cu``), each feature batch's log-mel on another
(``ops/csrc/mel.cu``). The package imports torch, numpy, scipy and the
standard library only: nothing of JAX, flax or ``everyvoice_tpu``.
"""
