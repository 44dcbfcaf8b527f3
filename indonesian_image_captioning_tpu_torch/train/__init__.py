"""The caption trainer's steps (the port's ``train/steps.py``)."""
