"""Cross-cutting utilities of the port: checkpoint/resume
(``checkpoint.py``) and the training data pipeline (``data.py``)."""
