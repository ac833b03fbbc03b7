"""Training-side helpers of the port; so far the prompt-embedding
precompute of `cli embed` and the LoRA merge of the captioner's loader."""
