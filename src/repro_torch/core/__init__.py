"""Compression engine: matrixize, orthogonalize, dist, simmesh, engine, powersgd, error_feedback, compressors."""
