"""Core runtime: types, twiddle tables, permutations, windows.

The analog of the reference's common runtime layer
(reference: include/fft_common.h, utils/fft_utils.c).
"""
