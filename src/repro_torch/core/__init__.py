"""ProMiSH core: datatypes, index build, planning, subset search and the distance backends."""
