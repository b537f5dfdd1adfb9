"""StyleTTS2 text-to-wav serving: the generator stack, PL-BERT and synthesis."""
