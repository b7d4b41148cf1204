"""Training: the AdamW update and the train step."""
