"""The fault plane: its state leaves and schedules (``schedule.py``) and the
fault phase that opens every tick's prefix (``apply.py``)."""
