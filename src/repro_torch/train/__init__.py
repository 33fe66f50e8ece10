"""The optimizer, the train and serve steps, and the trainer."""
