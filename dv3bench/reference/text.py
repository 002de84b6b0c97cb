# coding: utf-8
"""Text -> symbol ids for the English frontend's character input, written
from its published symbol table (r9y9/deepvoice3_pytorch,
deepvoice3_pytorch/frontend/text/symbols.py: pad, eos, the characters
below, then the '@'-prefixed ARPAbet symbols). The traffic's texts are
lowercase words, single spaces and `,` `.`, which the English cleaners
leave as they are, and no pronunciation is mixed in (p = 0)."""

PAD, EOS = 0, 1
CHARACTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "
N_ARPABET = 84
N_VOCAB = 2 + len(CHARACTERS) + N_ARPABET


def text_to_ids(text):
    """ids of the cleaned text with EOS appended. Raises on a character the
    traffic should not produce (the cleaners would change it)."""
    if text != " ".join(text.lower().split()):
        raise ValueError("text is not in cleaned form: %r" % (text,))
    return [2 + CHARACTERS.index(c) for c in text] + [EOS]
