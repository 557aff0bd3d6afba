"""The offer side of the scheduler: so far only the placement-rule
parser the spec validators need."""
