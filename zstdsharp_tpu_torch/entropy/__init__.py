"""The port's FSE and Huffman host codecs and bitstreams."""
