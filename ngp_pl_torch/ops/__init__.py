"""Operators of the port: hash encoding (K1), field tail (K7), SH,
TruncExp, intersection, ray marching and compositing."""
