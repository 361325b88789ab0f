"""Training: AdamW and the train step."""
