"""The work each kernel or step needs, counted from the inputs' sizes, and
the card's peaks. One file a kernel or step; :mod:`.peaks` turns a count
into the least time the card could take."""
