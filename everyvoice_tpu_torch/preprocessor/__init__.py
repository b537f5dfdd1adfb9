"""Preprocessing: wavs and filelists → the artifacts training reads."""

from everyvoice_tpu_torch.preprocessor.preprocessor import Preprocessor  # noqa: F401
