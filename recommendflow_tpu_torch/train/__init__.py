"""Inference over a dataset; the trainer grows here with the training slice."""
