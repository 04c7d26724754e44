"""The LM substrate's training and step factories: AdamW, the train,
prefill and decode steps, checkpoints, the step monitor."""
