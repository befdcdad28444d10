"""Gate, K-compression cache, block selection and decode options."""
