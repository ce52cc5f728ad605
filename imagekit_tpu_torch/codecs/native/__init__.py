"""Native (C++) host-side codecs of the port, loaded with ctypes.

Copies of the reference's sources (``imagekit_tpu/codecs/native/``) that the
port links: ``jpeg_entropy.cpp`` (baseline JPEG Huffman decode and
encode), ``vp8_encode.cpp`` (VP8/WebP encode) and ``png_decode.cpp`` (PNG
inflate, unfilter and expansion). :mod:`.loader` builds them at first use
into ``build/imagekit_tpu_torch/`` under the checkout.
"""
