"""Long-audio CTC segmentation: the wav2vec2-CTC acoustic model and the
forced alignment, TextGrid and extraction around it."""
