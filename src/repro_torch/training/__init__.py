"""The training substrate: AdamW with int8 error feedback (``optimizer``)
and the train state and step (``train_step``)."""
