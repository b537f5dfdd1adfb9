"""PyTorch/CUDA port of everyvoice_tpu, slice by slice: FastSpeech2 +
HiFiGAN synthesis from the JAX package's EVTP checkpoints (wav, spec,
TextGrid and read-along outputs, style references); preprocessing of a
corpus into the artifacts training reads, with G2P and phonological
features; FastSpeech2 training (characters or phones, global style tokens);
HiFiGAN training (V1, ResBlock2, the iSTFT head) and its export; and the
command line over the JAX package's YAML/JSON project files
(``python -m everyvoice_tpu_torch``). Each HiFiGAN MRF stage runs on a
hand-written sm_90a CUDA kernel (``ops/csrc/mrf.cu``), each feature batch's
log-mel on another (``ops/csrc/mel.cu``). The package imports torch, numpy,
scipy and the standard library only: nothing of JAX, flax or
``everyvoice_tpu``.
"""
