"""The runners of the traffic kinds: a mix's `kind` names its module here."""
