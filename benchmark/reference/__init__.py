"""The plain float32 reference of the OCR pipeline (and its fp8 control),
which imports nothing of the program under test."""
