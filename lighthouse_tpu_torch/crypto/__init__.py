"""Host-side cryptography of the PyTorch port."""
