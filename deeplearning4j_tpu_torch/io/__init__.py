"""Model files: the serializer (``model_serializer.py``) and the
checkpoint listener (``checkpoint.py``)."""
