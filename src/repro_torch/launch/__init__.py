"""Step builders of the LM stack (``repro.launch``)."""
