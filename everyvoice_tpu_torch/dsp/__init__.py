"""Audio IO of the port."""

from everyvoice_tpu_torch.dsp.audio_io import write_wav  # noqa: F401
