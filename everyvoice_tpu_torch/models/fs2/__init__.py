"""FastSpeech2 inference and text-to-wav serving."""
