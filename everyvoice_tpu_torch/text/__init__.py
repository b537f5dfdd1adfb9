"""Character-level text front end: normalization, tokenization, encoding."""

from everyvoice_tpu_torch.text.text_processor import (  # noqa: F401
    CHARACTER_JOINER,
    JOINER_SUBSTITUTION,
    PAD_SYMBOL,
    OutOfVocabularySymbolError,
    TextProcessor,
)
from everyvoice_tpu_torch.text.textsplit import chunk_text  # noqa: F401
