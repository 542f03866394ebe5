"""Bag-of-words place recognition: the vocabulary and the keyframe database."""
