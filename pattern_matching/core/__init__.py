from pattern_matching.core.dfa import AhoCorasick, DfaTable, Pattern  # noqa: F401
