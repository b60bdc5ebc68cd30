"""Utilities of the PyTorch port: device/dtype conventions, logging, kernel builds."""
