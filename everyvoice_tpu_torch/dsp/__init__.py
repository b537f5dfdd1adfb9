"""Audio IO and the feature front end's DSP of the port."""

from everyvoice_tpu_torch.dsp.audio_io import read_wav, write_wav  # noqa: F401
