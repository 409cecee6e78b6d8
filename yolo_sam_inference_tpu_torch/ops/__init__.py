"""Tensor functions and the kernel wrappers (dispatch by tensor device)."""
