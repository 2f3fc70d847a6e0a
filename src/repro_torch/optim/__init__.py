"""Row-wise int8 quantization of the serving corpus."""
